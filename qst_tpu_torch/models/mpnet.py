"""MPNet encoder as ``nn.Module``s — counterpart of ``qst_tpu/models/mpnet.py``.

The family of the reference's stronger checkpoint (all-mpnet-base-v2):
RoBERTa-style padding-aware learned positions and a T5-style relative
position bias, one (32 buckets, heads) table shared by every layer and added
to every attention-logit matrix. Module and parameter names follow HF
``MPNetModel`` (``embeddings.{word_embeddings, position_embeddings,
LayerNorm}``, ``encoder.layer.N.attention.attn.{q,k,v,o}``,
``encoder.layer.N.attention.LayerNorm``, ``intermediate.dense``,
``output.{dense, LayerNorm}``, ``encoder.relative_attention_bias``), so a
checkpoint's state dict loads as it is. The forward keeps the Flax path's
semantics, as ``models/bert.py`` does for BERT: f32 parameters, products in
``cfg.dtype``, f32 logits, softmax and LayerNorm statistics, exact-erf GELU,
dropout at the Flax sites from a ``dropout_generator`` in train() mode.

``padding_aware_position_ids`` and ``relative_position_bucket`` are copies
of the source's (``qst_tpu/models/mpnet.py:29,37``), the bucket in HF's
torch form, computed on the host once per length and device.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import torch
from torch import nn

from qst_tpu_torch.core.config import EncoderConfig
from qst_tpu_torch.models.bert import (
    MASK_BIAS,
    SITE_ATTENTION_OUT,
    SITE_EMBEDDINGS,
    SITE_PROBS,
    BertIntermediate,
    BertOutput,
    _dropout,
    _layer_norm_f32,
    _Linear,
    _remat_layer,
    at_layer,
    compute_dtype,
)

RELATIVE_BUCKETS = 32
RELATIVE_MAX_DISTANCE = 128

# a layer's parts under MPNet's names (models/bert.py TensorParallelLayer)
MPNET_LAYER_PARTS = {"q": "attention.attn.q", "k": "attention.attn.k", "v": "attention.attn.v",
                     "o": "attention.attn.o", "ln1": "attention.LayerNorm",
                     "i": "intermediate.dense", "out": "output.dense",
                     "ln2": "output.LayerNorm"}


def padding_aware_position_ids(input_ids: torch.Tensor, pad_id: int) -> torch.Tensor:
    """fairseq/RoBERTa position ids: positions count non-pad tokens starting
    at pad_id + 1; pad positions get pad_id."""
    mask = (input_ids != pad_id).long()
    return torch.cumsum(mask, dim=1) * mask + pad_id


def relative_position_bucket(relative_position: torch.Tensor,
                             num_buckets: int = RELATIVE_BUCKETS,
                             max_distance: int = RELATIVE_MAX_DISTANCE) -> torch.Tensor:
    """Bidirectional T5-style bucketing (HF MPNet semantics)."""
    n = -relative_position
    num_buckets //= 2
    ret = (n < 0).long() * num_buckets
    n = torch.abs(n)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        torch.log(n.float() / max_exact) / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)).long()
    val_if_large = torch.clamp(val_if_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


@functools.lru_cache(maxsize=32)
def _buckets(S: int, device: str) -> torch.Tensor:
    pos = torch.arange(S)
    return relative_position_bucket(pos[None, :] - pos[:, None]).to(device)


def position_buckets(S: int, device) -> torch.Tensor:
    """(S, S) bucket ids of (query i, key j) = bucket(j - i), made on the
    host once per (length, device) and kept on ``device``, so that a step
    captured into a CUDA graph copies nothing from the host."""
    return _buckets(S, str(torch.device(device)))


class MPNetEmbeddings(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = compute_dtype(self.cfg)
        pos_ids = padding_aware_position_ids(input_ids, self.cfg.pad_token_id)
        word = self.word_embeddings(input_ids).to(dt)
        pos = self.position_embeddings(pos_ids).to(dt)
        x = _layer_norm_f32(self.LayerNorm, word + pos)
        return _dropout(self, x, self.cfg.hidden_dropout, dropout_generator,
                        SITE_EMBEDDINGS).to(dt)


class MPNetSelfAttention(nn.Module):
    """HF ``MPNetSelfAttention``: q, k, v, o (``MPNetAttention``, :56)."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.rate = cfg.attention_dropout
        H = cfg.hidden_size
        self.q, self.k, self.v, self.o = (_Linear(H, H) for _ in range(4))

    def forward(self, hidden: torch.Tensor, bias: torch.Tensor,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, S, H = hidden.shape
        nh = self.num_heads
        hd = H // nh

        def heads(t):
            return t.reshape(B, S, nh, hd).float()

        q, k, v = heads(self.q(hidden)), heads(self.k(hidden)), heads(self.v(hidden))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd) + bias
        probs = torch.softmax(logits, dim=-1).to(hidden.dtype)
        probs = _dropout(self, probs, self.rate, dropout_generator, SITE_PROBS)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v).reshape(B, S, H)
        return self.o(ctx.to(hidden.dtype))


class MPNetAttention(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.attn = MPNetSelfAttention(cfg)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.rate = cfg.hidden_dropout

    def forward(self, hidden: torch.Tensor, bias: torch.Tensor,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        out = _dropout(self, self.attn(hidden, bias, dropout_generator), self.rate,
                       dropout_generator, SITE_ATTENTION_OUT)
        return _layer_norm_f32(self.LayerNorm, out + hidden).to(hidden.dtype)


class MPNetLayer(nn.Module):
    """``MPNetLayer`` (:82): attention, LayerNorm, erf-GELU FFN, LayerNorm."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.attention = MPNetAttention(cfg)
        self.intermediate = BertIntermediate(cfg)
        self.output = BertOutput(cfg)

    def forward(self, hidden: torch.Tensor, bias: torch.Tensor,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        hidden = self.attention(hidden, bias, dropout_generator)
        return self.output(self.intermediate(hidden), hidden, dropout_generator)


class _MPNetStack(nn.Module):
    """HF's ``MPNetEncoder``: the ``encoder.layer`` list and the shared
    ``relative_attention_bias`` table (buckets, heads)."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.layer = nn.ModuleList(MPNetLayer(cfg) for _ in range(cfg.num_layers))
        self.relative_attention_bias = nn.Embedding(RELATIVE_BUCKETS, cfg.num_heads)


@functools.lru_cache(maxsize=32)
def _offset_buckets(S: int, device: str) -> torch.Tensor:
    """(2S - 1, 32) f32 one-hot of the bucket of each offset j - i = d - (S - 1)."""
    d = torch.arange(-(S - 1), S)
    return torch.nn.functional.one_hot(relative_position_bucket(d), RELATIVE_BUCKETS).float().to(
        device)


def diagonal_sums(m: torch.Tensor) -> torch.Tensor:
    """(n, S, S) → (n, 2S - 1): entry d the sum of m[:, i, i + d - (S - 1)]
    over the rows i where that column exists. The rows are padded with
    S - 1 zeros on either side, so that a view with row stride 3S - 1 puts
    each diagonal in one column; a plain sum over the rows adds it up, in a
    fixed order."""
    n, S, _ = m.shape
    padded = torch.nn.functional.pad(m, (S - 1, S - 1)).contiguous()     # (n, S, 3S - 2)
    skew = padded.as_strided((n, S, 2 * S - 1), (S * (3 * S - 2), 3 * S - 1, 1))
    return skew.sum(dim=1)


class _RelativeBias(torch.autograd.Function):
    """The (buckets, nh) table → the (nh, S, S) bias, gathered with
    ``F.embedding`` (its ids fall into 32 buckets in long runs: PR 8 found an
    index's backward sums a run in one block). Its backward does not go
    through ``F.embedding``'s, which is not the same from run to run on the
    card for 32 rows and S² ids, and a captured train step must repeat its
    eager steps bit for bit: every bucket is a set of offsets j - i, so the
    gradient is the bias gradient summed along its diagonals
    (``diagonal_sums``) and then over each bucket's offsets — sums over
    fixed shapes, with no atomics."""

    @staticmethod
    def forward(ctx, table, S):
        ctx.S = S
        return torch.nn.functional.embedding(position_buckets(S, table.device),
                                             table).permute(2, 0, 1).contiguous()

    @staticmethod
    def backward(ctx, g):
        onehot = _offset_buckets(ctx.S, str(g.device))
        per_offset = diagonal_sums(g.float())                            # (nh, 2S - 1)
        return (per_offset[:, :, None] * onehot[None]).sum(dim=1).t(), None


class _PositionEmbeddings(torch.autograd.Function):
    """``F.embedding(padding_aware_position_ids(ids, pad_id), weight)`` whose
    backward is not ``F.embedding``'s: for MPNet's 514 positions and B·S ids
    that one is not the same from run to run on the card (seen at
    MPNet-base, B = 128, S = 128), and a captured train step must repeat its
    eager steps bit for bit. A token's position is pad_id + its offset, the
    count of non-pad tokens up to it (0 for a pad): within a sequence the
    non-pad offsets are distinct, so the gradient rows scatter into a
    (B, S + 1, H) buffer without colliding (the pads' rows, zeroed, all land
    at offset 0), and a sum over the sequences gives each position's
    gradient; the pads' own row is their masked sum. No atomics, no
    library product."""

    @staticmethod
    def forward(ctx, input_ids, weight, pad_id):
        pos = padding_aware_position_ids(input_ids, pad_id)
        ctx.save_for_backward(pos)
        ctx.rows, ctx.pad_id = weight.shape[0], pad_id
        return torch.nn.functional.embedding(pos, weight)

    @staticmethod
    def backward(ctx, g):
        (pos,) = ctx.saved_tensors
        B, S, H = g.shape
        g = g.float()
        offset = pos - ctx.pad_id
        real = (offset > 0)[..., None]
        rows = torch.zeros((B, S + 1, H), dtype=torch.float32, device=g.device)
        rows.scatter_(1, offset[..., None].expand(B, S, H), torch.where(real, g, 0.0))
        grad = torch.zeros((ctx.rows, H), dtype=torch.float32, device=g.device)
        n = min(S, ctx.rows - ctx.pad_id - 1)
        grad[ctx.pad_id + 1:ctx.pad_id + 1 + n] = rows[:, 1:n + 1].sum(dim=0)
        grad[ctx.pad_id] = torch.where(real, 0.0, g).sum(dim=(0, 1))
        return None, grad, None


def position_embeddings(input_ids: torch.Tensor, weight: torch.Tensor,
                        pad_id: int) -> torch.Tensor:
    """MPNet's padding-aware position embeddings of ``input_ids``, with a
    deterministic gradient (``_PositionEmbeddings``)."""
    return _PositionEmbeddings.apply(input_ids, weight, pad_id)


def relative_bias(table: torch.Tensor, S: int) -> torch.Tensor:
    """The (nh, S, S) f32 relative bias of the (buckets, nh) table; its
    gradient flows back to the table deterministically (``_RelativeBias``)."""
    return _RelativeBias.apply(table.float(), S)


class MPNetEncoder(nn.Module):
    """Token-level encoder: ids/mask → last hidden state (B, S, H), the
    counterpart of qst_tpu's Flax ``MPNetEncoder`` (HF ``MPNetModel``
    without its pooler)."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        if cfg.arch != "mpnet":
            raise ValueError(f"MPNetEncoder needs arch='mpnet', got {cfg.arch!r}")
        self.cfg = cfg
        self.embeddings = MPNetEmbeddings(cfg)
        self.encoder = _MPNetStack(cfg)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``token_type_ids`` is accepted and unused (MPNet has none);
        ``dropout_generator``: in train() mode, the config's dropout."""
        del token_type_ids
        S = input_ids.shape[1]
        input_ids = input_ids.long()
        hidden = self.embeddings(input_ids, at_layer(dropout_generator, self.cfg.num_layers))
        rel = relative_bias(self.encoder.relative_attention_bias.weight, S)[None]
        pad = torch.where(attention_mask[:, None, None, :] > 0, 0.0, MASK_BIAS).float()
        bias = rel + pad
        remat = self.cfg.remat and torch.is_grad_enabled() and hidden.requires_grad
        for i, layer in enumerate(self.encoder.layer):
            gen = at_layer(dropout_generator, i)
            if remat:
                hidden = _remat_layer(layer, hidden, bias, gen)
            else:
                hidden = layer(hidden, bias, gen)
        return hidden


def import_mpnet_params(state_dict, cfg: EncoderConfig) -> Dict[str, torch.Tensor]:
    """An HF ``MPNetModel`` state dict (tensors or arrays, with or without an
    ``mpnet.`` / sentence-transformers prefix) → the state dict of
    ``MPNetEncoder(cfg)``, which is also ``SentenceEncoderModule(cfg)``'s
    (``qst_tpu/models/mpnet.py:145``); ``models/hf_import.py:select_trunk``
    says what raises."""
    from qst_tpu_torch.models.hf_import import select_trunk

    return select_trunk(state_dict, cfg, "mpnet")

