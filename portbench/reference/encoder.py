"""BERT and MPNet sentence encoders in plain float32 PyTorch.

``sd`` holds the Hugging Face ``BertModel`` / ``MPNetModel`` tensor names
(no pooler). Post-LayerNorm layers, exact-erf GELU, additive −1e9 on padded
keys; BERT adds learned absolute positions and token type 0, MPNet
padding-aware positions (pad id + 1 onwards) and a T5-style relative
attention bias (32 buckets, max distance 128) shared by every layer. The
sentence embedding is the masked mean of the last hidden state, L2
normalised, as sentence-transformers' mean-pooling models give it.

``dropout`` = (run seed, step, nb) applies the configuration's dropout
with the masks of ``dropout.py``; None runs the model in eval mode.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch

from portbench.reference import dropout as drops
from portbench.reference.precision import einsum, matmul


def _ln(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def _linear(x, sd, name, precision):
    return matmul(x, sd[name + ".weight"].t(), precision) + sd[name + ".bias"]


def relative_buckets(S: int, num_buckets: int = 32, max_distance: int = 128,
                     device=None) -> torch.Tensor:
    """(S, S) bucket of key j seen from query i (MPNet, T5's bidirectional rule)."""
    pos = torch.arange(S, device=device)
    n = -(pos[None, :] - pos[:, None])
    half = num_buckets // 2
    ret = (n < 0).long() * half
    n = n.abs()
    exact = half // 2
    large = exact + (torch.log(n.clamp(min=1).float() / exact) / math.log(max_distance / exact)
                     * (half - exact)).long()
    large = large.clamp(max=half - 1)
    return ret + torch.where(n < exact, n, large)


LAYER_NAMES = {
    "bert": dict(q="attention.self.query", k="attention.self.key", v="attention.self.value",
                 o="attention.output.dense", ln1="attention.output.LayerNorm"),
    "mpnet": dict(q="attention.attn.q", k="attention.attn.k", v="attention.attn.v",
                  o="attention.attn.o", ln1="attention.LayerNorm"),
}


def _embeddings(cfg: Mapping, sd: Mapping[str, torch.Tensor], ids: torch.Tensor) -> torch.Tensor:
    S = ids.shape[1]
    x = sd["embeddings.word_embeddings.weight"][ids]
    if cfg["model_type"] == "mpnet":
        pad = cfg["pad_token_id"]
        real = (ids != pad).long()
        pos = torch.cumsum(real, 1) * real + pad
        x = x + sd["embeddings.position_embeddings.weight"][pos]
    else:
        x = (x + sd["embeddings.position_embeddings.weight"][:S][None]
             + sd["embeddings.token_type_embeddings.weight"][0][None, None])
    return _ln(x, sd["embeddings.LayerNorm.weight"], sd["embeddings.LayerNorm.bias"],
               cfg["layer_norm_eps"])


def hidden_states(cfg: Mapping, sd: Mapping[str, torch.Tensor], ids: torch.Tensor,
                  mask: torch.Tensor, precision: str = "f32",
                  dropout: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """(B, S) ids and mask → (B, S, H) last hidden state."""
    B, S = ids.shape
    H, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    hd = H // nh
    L = cfg["num_hidden_layers"]
    eps = cfg["layer_norm_eps"]
    names = LAYER_NAMES[cfg["model_type"]]
    x = _embeddings(cfg, sd, ids)
    seeds = None
    if dropout is not None:
        run_seed, step, nb = dropout
        base, seeds = drops.step_seeds(run_seed, step, L)
        p_hid, p_att = cfg["hidden_dropout_prob"], cfg["attention_probs_dropout_prob"]
        x = x * drops.embedding_mask((B, S, H), base, p_hid, ids.device)
    bias = torch.where(mask > 0, 0.0, -1e9).float()[:, None, None, :]
    if cfg["model_type"] == "mpnet":
        buckets = relative_buckets(S, cfg["relative_attention_num_buckets"], device=ids.device)
        table = sd["encoder.relative_attention_bias.weight"]          # (buckets, heads)
        bias = bias + table[buckets].permute(2, 0, 1)[None]
    for i in range(L):
        pre = f"encoder.layer.{i}."

        def heads(t):
            return t.reshape(B, S, nh, hd)

        q = heads(_linear(x, sd, pre + names["q"], precision))
        k = heads(_linear(x, sd, pre + names["k"], precision))
        v = heads(_linear(x, sd, pre + names["v"], precision))
        scores = einsum("bqhd,bkhd->bhqk", q, k, precision) / math.sqrt(hd) + bias
        p = torch.softmax(scores, dim=-1)
        if seeds is not None:
            p = p * drops.attention_mask(B, nh, S, seeds[i], p_att, nb, ids.device)
        ctx = einsum("bhqk,bkhd->bqhd", p, v, precision).reshape(B, S, H)
        a = _linear(ctx, sd, pre + names["o"], precision)
        if seeds is not None:
            a = a * drops.hidden_mask(B, S, H, seeds[i], p_hid, nb, 0, ids.device)
        y = _ln(a + x, sd[pre + names["ln1"] + ".weight"], sd[pre + names["ln1"] + ".bias"], eps)
        f = _linear(_gelu(_linear(y, sd, pre + "intermediate.dense", precision)), sd,
                    pre + "output.dense", precision)
        if seeds is not None:
            f = f * drops.hidden_mask(B, S, H, seeds[i], p_hid, nb, 1, ids.device)
        x = _ln(f + y, sd[pre + "output.LayerNorm.weight"], sd[pre + "output.LayerNorm.bias"], eps)
    return x


def embed(cfg: Mapping, sd: Mapping[str, torch.Tensor], ids: torch.Tensor, mask: torch.Tensor,
          precision: str = "f32", dropout: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """(B, S) ids and mask → (B, H) unit sentence embeddings (masked mean)."""
    h = hidden_states(cfg, sd, ids, mask, precision, dropout)
    m = mask[..., None].float()
    pooled = (h * m).sum(1) / m.sum(1).clamp(min=1e-9)
    return pooled / pooled.norm(dim=-1, keepdim=True).clamp(min=1e-12)


def embed_texts(cfg: Mapping, sd: Mapping[str, torch.Tensor], tokenizer, texts, max_length: int,
                device, precision: str = "f32", block: int = 64) -> torch.Tensor:
    """Each text encoded at its own length (blocks of similar lengths, each
    padded only to its longest) → (len(texts), H) f32 on ``device``."""
    rows = [tokenizer.encode(t, max_length) for t in texts]
    order = sorted(range(len(rows)), key=lambda r: len(rows[r]))
    out = torch.empty((len(rows), cfg["hidden_size"]), device=device)
    pad = tokenizer.pad
    with torch.no_grad():
        for lo in range(0, len(order), block):
            sel = order[lo:lo + block]
            S = max(len(rows[r]) for r in sel)
            ids = torch.full((len(sel), S), pad, dtype=torch.int64)
            mask = torch.zeros((len(sel), S), dtype=torch.int64)
            for j, r in enumerate(sel):
                ids[j, :len(rows[r])] = torch.tensor(rows[r])
                mask[j, :len(rows[r])] = 1
            out[torch.tensor(sel, device=device)] = embed(
                cfg, sd, ids.to(device), mask.to(device), precision)
    return out


def f32_weights(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().float() for k, v in sd.items()}
