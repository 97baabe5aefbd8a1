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

``use_flash_attention`` (a library kernel on the TPU) has no counterpart yet:
a config that sets it raises rather than run another attention than it asked
for. ``remat`` recomputes each layer in the backward instead of keeping its
activations (Flax's ``nn.remat``): the same values and gradients for less
memory. Only ``arch="bert"`` is ported; MPNet and RoBERTa wait for a later
slice.
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
        dt = compute_dtype(self.cfg)
        word = self.word_embeddings(input_ids).to(dt)
        pos = self.position_embeddings(position_ids).to(dt)
        typ = self.token_type_embeddings(
            torch.clamp(token_type_ids, max=self.cfg.type_vocab_size - 1)).to(dt)
        x = _layer_norm_f32(self.LayerNorm, word + pos + typ)
        return _dropout(self, x, self.cfg.hidden_dropout, dropout_generator).to(dt)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.rate = cfg.attention_dropout
        H = cfg.hidden_size
        self.query = _Linear(H, H)
        self.key = _Linear(H, H)
        self.value = _Linear(H, H)

    def forward(self, hidden: torch.Tensor, bias: torch.Tensor,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, S, H = hidden.shape
        nh = self.num_heads
        hd = H // nh

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
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.output(self.self(hidden, bias, dropout_generator), hidden,
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
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        hidden = self.attention(hidden, bias, dropout_generator)
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
        if cfg.arch != "bert":
            raise NotImplementedError(
                f"arch={cfg.arch!r} is not ported to qst_tpu_torch (bert only)")
        if cfg.use_flash_attention:
            raise NotImplementedError(
                "use_flash_attention=True: the blocked attention kernel for long sequences "
                "is not ported to qst_tpu_torch yet; the flag is not ignored")
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = _LayerStack(cfg)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``dropout_generator``: in train() mode, apply the config's dropout
        with masks drawn from it (Flax's ``deterministic=False``)."""
        B, S = input_ids.shape
        input_ids = input_ids.long()
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        position_ids = torch.arange(S, device=input_ids.device)[None, :].expand(B, S)
        hidden = self.embeddings(input_ids, token_type_ids.long(), position_ids,
                                 dropout_generator)
        bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0, MASK_BIAS).float()
        remat = self.cfg.remat and torch.is_grad_enabled() and hidden.requires_grad
        for layer in self.encoder.layer:
            if remat:
                hidden = _remat_layer(layer, hidden, bias, dropout_generator)
            else:
                hidden = layer(hidden, bias, dropout_generator)
        return hidden


def _remat_layer(layer: nn.Module, hidden: torch.Tensor, bias: torch.Tensor,
                 gen: Optional[torch.Generator]) -> torch.Tensor:
    """One layer under ``torch.utils.checkpoint``: its activations are
    recomputed in the backward. The dropout masks come from ``gen``, whose
    state checkpoint does not keep: the recomputation starts from the state
    the forward started from (and puts back the one it found), so it draws
    the same masks."""
    if gen is None:
        return checkpoint(layer, hidden, bias, None, use_reentrant=False)
    start = gen.get_state()
    first = [True]

    def run(h, b):
        if first[0]:
            first[0] = False
            return layer(h, b, gen)
        now = gen.get_state()
        gen.set_state(start)
        try:
            return layer(h, b, gen)
        finally:
            gen.set_state(now)

    return checkpoint(run, hidden, bias, use_reentrant=False)
