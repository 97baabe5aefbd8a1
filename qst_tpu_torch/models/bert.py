"""BERT encoder as ``nn.Module``s — counterpart of ``qst_tpu/models/bert.py``.

Module and parameter names follow HF ``BertModel`` (``embeddings.*``,
``encoder.layer.N.attention.self.query.*``, ...), so a checkpoint's state
dict loads as it is. The forward keeps the Flax path's semantics
(deterministic, i.e. no dropout):

- params stay f32; every projection runs in ``cfg.dtype`` (inputs, weight
  and bias cast to it, as Flax's ``Dense(dtype=...)`` does);
- attention logits and probabilities·V accumulate in f32 (operands upcast
  before the product), the softmax is f32, with a −1e9 additive pad bias;
- both LayerNorms take f32 statistics; the GELU is exact-erf;
- casts to ``cfg.dtype`` at the same points as the Flax modules.

``use_flash_attention`` (a library kernel on the TPU) is not on this path.
Only ``arch="bert"`` is ported; MPNet and RoBERTa wait for a later slice.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

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
                position_ids: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(self.cfg)
        word = self.word_embeddings(input_ids).to(dt)
        pos = self.position_embeddings(position_ids).to(dt)
        typ = self.token_type_embeddings(
            torch.clamp(token_type_ids, max=self.cfg.type_vocab_size - 1)).to(dt)
        return _layer_norm_f32(self.LayerNorm, word + pos + typ).to(dt)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.num_heads = cfg.num_heads
        H = cfg.hidden_size
        self.query = _Linear(H, H)
        self.key = _Linear(H, H)
        self.value = _Linear(H, H)

    def forward(self, hidden: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        B, S, H = hidden.shape
        nh = self.num_heads
        hd = H // nh

        def heads(t):
            return t.reshape(B, S, nh, hd).float()

        q, k, v = heads(self.query(hidden)), heads(self.key(hidden)), heads(self.value(hidden))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        probs = torch.softmax(logits + bias, dim=-1).to(hidden.dtype)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v)
        return ctx.reshape(B, S, H).to(hidden.dtype)


class BertSelfOutput(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.dense = _Linear(cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, ctx: torch.Tensor, hidden: torch.Tensor) -> torch.Tensor:
        return _layer_norm_f32(self.LayerNorm, self.dense(ctx) + hidden).to(hidden.dtype)


class BertAttention(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.self = BertSelfAttention(cfg)
        self.output = BertSelfOutput(cfg)

    def forward(self, hidden: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        return self.output(self.self(hidden, bias), hidden)


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

    def forward(self, inter: torch.Tensor, hidden: torch.Tensor) -> torch.Tensor:
        return _layer_norm_f32(self.LayerNorm, self.dense(inter) + hidden).to(hidden.dtype)


class BertLayer(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.attention = BertAttention(cfg)
        self.intermediate = BertIntermediate(cfg)
        self.output = BertOutput(cfg)

    def forward(self, hidden: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        hidden = self.attention(hidden, bias)
        return self.output(self.intermediate(hidden), hidden)


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
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = _LayerStack(cfg)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, S = input_ids.shape
        input_ids = input_ids.long()
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        position_ids = torch.arange(S, device=input_ids.device)[None, :].expand(B, S)
        hidden = self.embeddings(input_ids, token_type_ids.long(), position_ids)
        bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0, MASK_BIAS).float()
        for layer in self.encoder.layer:
            hidden = layer(hidden, bias)
        return hidden
