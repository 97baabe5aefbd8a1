"""BERT encoder as ``nn.Module``s — counterpart of ``qst_tpu/models/bert.py``.

Module and parameter names follow HF ``BertModel`` (``embeddings.*``,
``encoder.layer.N.attention.self.query.*``, ...), so a checkpoint's state
dict loads as it is. The forward keeps the Flax path's semantics:

- params stay f32; every projection runs in ``cfg.dtype`` (inputs, weight
  and bias cast to it, as Flax's ``Dense(dtype=...)`` does);
- attention logits and probabilities·V accumulate in f32 (operands upcast
  before the product), the softmax is f32, with a −1e9 additive pad bias;
- both LayerNorms take f32 statistics; the GELU is exact-erf;
- casts to ``cfg.dtype`` at the same points as the Flax modules;
- dropout at the Flax sites — the embeddings after their LayerNorm, the
  attention probabilities, the attention output and the FFN output — only
  in ``train()`` mode and only when the forward is given a
  ``dropout_generator``, from which every mask is drawn (Flax's
  ``where(keep, x / keep_prob, 0)``; the bits are the generator's, not
  JAX's).

``use_flash_attention`` routes the self-attention as qst_tpu's gate does
(``_flash_attention_available``: S ≥ 128, a multiple of 128, and no active
attention dropout) through ``ops/flash_attention.py``'s ``FlashAttention``
(K7 forward, K8 backward; their plain versions on the CPU), with the
library's segment-id semantics: seg = the attention mask, so a padded query
row attends to the padded keys only (its ``token_embeddings`` row differs
from the einsum path's; the pooled embedding does not). ``remat``
recomputes each layer in the backward instead of keeping its activations
(Flax's ``nn.remat``): the same values and gradients for less memory.
MPNet is ``models/mpnet.py``. RoBERTa (``arch="roberta"``) is this trunk
with BERT's state-dict layout and two changes, as in the source: its
positions are the padding-aware (B, S) ids of ``padding_aware_position_ids``
(counted from ``pad_token_id`` + 1 over the non-pad tokens), and its one
token-type row takes every segment (the ids are clamped to
``type_vocab_size - 1``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from qst_tpu_torch.core.config import EncoderConfig

MASK_BIAS = -1e9


def compute_dtype(cfg: EncoderConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _flash_attention_available(cfg: EncoderConfig, seq_len: int,
                               deterministic: bool) -> bool:
    """qst_tpu/models/bert.py:59-70: the flash path applies when S fits the
    kernel's 128-key tiling and attention dropout (not in the kernel) is
    inactive."""
    if not cfg.use_flash_attention:
        return False
    if seq_len < 128 or seq_len % 128 != 0:
        return False
    if not deterministic and cfg.attention_dropout > 0.0:
        return False
    return True


class _Linear(nn.Linear):
    """``nn.Linear`` with f32 parameters that runs in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


def _layer_norm_f32(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), ln.eps)


def _dropout(module: nn.Module, x: torch.Tensor, rate: float,
             gen: Optional[torch.Generator]) -> torch.Tensor:
    """Flax ``nn.Dropout``: keep with probability 1 − rate and scale the kept
    values by 1/(1 − rate) in x's dtype; active in train() mode with a
    generator (drawn on the generator's device)."""
    if not module.training or gen is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=gen.device).to(x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        H = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, H)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, H)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, H)
        self.LayerNorm = nn.LayerNorm(H, eps=cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor, token_type_ids: torch.Tensor,
                position_ids: torch.Tensor,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``position_ids`` (B or 1, S). The position and token-type rows
        are read so that BERT's gradients come back the same on every run:
        positions shared by the batch as one (1, S) lookup, whose backward
        sums the batch in a fixed order, and the few token types by a
        selection, not a lookup — on the card ``F.embedding``'s backward
        adds a row repeated across the batch in no fixed order (a captured
        train step must repeat its eager steps bit for bit). The values are
        the lookups'. RoBERTa's (B, S) positions are a lookup, as MPNet's
        are."""
        dt = compute_dtype(self.cfg)
        word = self.word_embeddings(input_ids).to(dt)
        pos = self.position_embeddings(position_ids).to(dt)
        types = torch.clamp(token_type_ids, max=self.cfg.type_vocab_size - 1)[..., None]
        table = self.token_type_embeddings.weight
        typ = table[0]
        for t in range(1, self.cfg.type_vocab_size):
            typ = torch.where(types == t, table[t], typ)
        x = _layer_norm_f32(self.LayerNorm, word + pos + typ.to(dt))
        return _dropout(self, x, self.cfg.hidden_dropout, dropout_generator).to(dt)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.num_heads = cfg.num_heads
        self.rate = cfg.attention_dropout
        H = cfg.hidden_size
        self.query = _Linear(H, H)
        self.key = _Linear(H, H)
        self.value = _Linear(H, H)

    def forward(self, hidden: torch.Tensor, bias: torch.Tensor,
                dropout_generator: Optional[torch.Generator] = None,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, S, H = hidden.shape
        nh = self.num_heads
        hd = H // nh
        deterministic = not self.training or dropout_generator is None
        if attention_mask is not None and _flash_attention_available(self.cfg, S, deterministic):
            from qst_tpu_torch.ops.flash_attention import FlashAttention

            def heads_t(t):   # (B, nh, S, hd) in the compute dtype, as it lies
                return t.reshape(B, S, nh, hd).transpose(1, 2)

            seg = attention_mask.to(torch.int32)
            ctx = FlashAttention.apply(heads_t(self.query(hidden)), heads_t(self.key(hidden)),
                                       heads_t(self.value(hidden)), seg, seg, float(hd) ** -0.5)
            return ctx.transpose(1, 2).reshape(B, S, H).to(hidden.dtype)

        def heads(t):
            return t.reshape(B, S, nh, hd).float()

        q, k, v = heads(self.query(hidden)), heads(self.key(hidden)), heads(self.value(hidden))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        probs = torch.softmax(logits + bias, dim=-1).to(hidden.dtype)
        probs = _dropout(self, probs, self.rate, dropout_generator)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v)
        return ctx.reshape(B, S, H).to(hidden.dtype)


class BertSelfOutput(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.dense = _Linear(cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.rate = cfg.hidden_dropout

    def forward(self, ctx: torch.Tensor, hidden: torch.Tensor,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        out = _dropout(self, self.dense(ctx), self.rate, dropout_generator)
        return _layer_norm_f32(self.LayerNorm, out + hidden).to(hidden.dtype)


class BertAttention(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.self = BertSelfAttention(cfg)
        self.output = BertSelfOutput(cfg)

    def forward(self, hidden: torch.Tensor, bias: torch.Tensor,
                dropout_generator: Optional[torch.Generator] = None,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.output(self.self(hidden, bias, dropout_generator, attention_mask), hidden,
                           dropout_generator)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.dense = _Linear(cfg.hidden_size, cfg.intermediate_size)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.dense(hidden).float(), approximate="none").to(hidden.dtype)


class BertOutput(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.dense = _Linear(cfg.intermediate_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.rate = cfg.hidden_dropout

    def forward(self, inter: torch.Tensor, hidden: torch.Tensor,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        out = _dropout(self, self.dense(inter), self.rate, dropout_generator)
        return _layer_norm_f32(self.LayerNorm, out + hidden).to(hidden.dtype)


class BertLayer(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.attention = BertAttention(cfg)
        self.intermediate = BertIntermediate(cfg)
        self.output = BertOutput(cfg)

    def forward(self, hidden: torch.Tensor, bias: torch.Tensor,
                dropout_generator: Optional[torch.Generator] = None,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``attention_mask`` (B, S): the segment ids of the flash path."""
        hidden = self.attention(hidden, bias, dropout_generator, attention_mask)
        return self.output(self.intermediate(hidden), hidden, dropout_generator)


class _LayerStack(nn.Module):
    """HF's ``BertEncoder``: the ``encoder.layer`` list."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg) for _ in range(cfg.num_layers))


class BertEncoder(nn.Module):
    """Token-level encoder: ids/mask → last hidden state (B, S, H), the
    counterpart of qst_tpu's Flax ``BertEncoder`` (HF ``BertModel`` without
    its pooler)."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        if cfg.arch not in ("bert", "roberta"):
            raise ValueError(f"BertEncoder runs arch 'bert' and 'roberta', got {cfg.arch!r}")
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = _LayerStack(cfg)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``dropout_generator``: in train() mode, apply the config's dropout
        with masks drawn from it (Flax's ``deterministic=False``)."""
        S = input_ids.shape[1]
        input_ids = input_ids.long()
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if self.cfg.arch == "roberta":
            # fairseq-style padding-aware positions offset by pad_token_id
            # (HF RobertaEmbeddings.create_position_ids_from_input_ids)
            from qst_tpu_torch.models.mpnet import padding_aware_position_ids

            position_ids = padding_aware_position_ids(input_ids, self.cfg.pad_token_id)
        else:
            position_ids = torch.arange(S, device=input_ids.device)[None, :]
        hidden = self.embeddings(input_ids, token_type_ids.long(), position_ids,
                                 dropout_generator)
        bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0, MASK_BIAS).float()
        remat = self.cfg.remat and torch.is_grad_enabled() and hidden.requires_grad
        for layer in self.encoder.layer:
            if remat:
                hidden = _remat_layer(layer, hidden, bias, dropout_generator, attention_mask)
            else:
                hidden = layer(hidden, bias, dropout_generator, attention_mask)
        return hidden


def _remat_layer(layer: nn.Module, hidden: torch.Tensor, bias: torch.Tensor,
                 gen: Optional[torch.Generator], *extra: torch.Tensor) -> torch.Tensor:
    """One layer under ``torch.utils.checkpoint``: its activations are
    recomputed in the backward. The dropout masks come from ``gen``, whose
    state checkpoint does not keep: the recomputation starts from the state
    the forward started from (and puts back the one it found), so it draws
    the same masks. ``extra``: the layer's arguments after the generator
    (BERT's attention mask)."""
    if gen is None:
        return checkpoint(layer, hidden, bias, None, *extra, use_reentrant=False)
    start = gen.get_state()
    first = [True]

    def run(h, b, *e):
        if first[0]:
            first[0] = False
            return layer(h, b, gen, *e)
        now = gen.get_state()
        gen.set_state(start)
        try:
            return layer(h, b, gen, *e)
        finally:
            gen.set_state(now)

    return checkpoint(run, hidden, bias, *extra, use_reentrant=False)
