"""K1 and K2: the fused BERT encoder layer, forward and backward —
counterpart of ``qst_tpu/ops/fused_layer_pallas.py``.

K1 replaces the TPU kernel ``_layer_kernel`` (``fused_layer_pallas.py:111``)
behind ``fused_bert_layer`` (``:189``); K2 replaces ``_layer_bwd_kernel``
(``:345``) behind ``_fused_layer_bwd`` (``:520``). On the H100 each is a
chain of hand-written kernels (``kernels/csrc/fused_layer.cu`` and
``fused_layer_bwd.cu``, sharing ``layer_common.cuh`` and ``hopper.cuh``): in
bfloat16 one persistent TMA + ``wgmma`` GEMM with the bias, erf-GELU,
dropout or residual applied in its epilogue (``layer_gemm`` runs it alone),
one ``mma.sync`` attention block per (sequence, head) whose (S, S)
probabilities stay in registers (S ≤ 128), or for 128 < S ≤ 512 key-blocked
attention with a running maximum and sum (``attention_kb.cuh``), and
warp-per-row LayerNorm with f32 statistics; in float32 SIMT kernels, the
path comparisons are held on. What bounds them and what the design does
about it is in those files' headers.

MPNet's relative-position bias (``rel_bias``, (nh·S, S) f32, shared by the
batch) is added to the logits after scale and mask bias in every attention
forward; K2 returns its gradient ``drel``, the logits' gradient summed over
the batch in a fixed order.

Training dropout is the TPU kernel's own: ``drop_mask_plain`` gives the bits
of ``_drop_mask`` (``:82-103``), a hash of (element, seed folded with the
grid step ``b // nb``, site tag), so the port's masks are the JAX package's
masks and K2 regenerates K1's. ``FusedBertLayer`` is the autograd function
(``_make_diff_layer``, ``:587``): it saves only the layer input and runs K2
as its backward.

``fused_bert_layer``, ``fused_bert_layer_bwd`` and ``drop_mask`` take their
plain versions only for tensors on the CPU; a CUDA tensor launches the
kernels or raises. Each counts its kernel launches in ``.launches``.

Scope of the CUDA path: S ≤ 512 (BERT's 512 positions; MPNet's 514 start at
pad + 1), head_dim 16, 32 or 64, float32 or bfloat16, deterministic (no
atomics).
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from qst_tpu_torch.core.config import EncoderConfig

MASK_BIAS = -1e9  # additive bias for padded key positions (models/bert.py)

# Weight order of the TPU kernel (fused_layer_pallas.py:51-54)
WEIGHT_NAMES = (
    "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo",
    "ln1_g", "ln1_b", "w1", "b1", "w2", "b2", "ln2_g", "ln2_b",
)
# What the CUDA entry point takes: Q, K and V as one (H, 3H) GEMM operand
_KERNEL_OPERANDS = ("wqkv", "bqkv") + WEIGHT_NAMES[6:]
_MATRICES = ("wqkv", "wo", "w1", "w2")
MAX_SEQ = 512  # max_position_embeddings of BERT (MPNet: 514 = 512 + pad + 1)
HEAD_DIMS = (16, 32, 64)


def _layernorm_f32(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """LayerNorm with f32 statistics over the last axis (x already f32)."""
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * gamma + beta


def _ln_stats(r: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n̂, 1/σ) of a LayerNorm over the last axis (``_ln_stats``, :316)."""
    mu = torch.mean(r, dim=-1, keepdim=True)
    var = torch.mean(torch.square(r - mu), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    return (r - mu) * inv, inv


def _ln_bwd(dy, nhat, inv, gamma):
    """→ (dr, dgamma, dbeta) of a LayerNorm given upstream dy (``_ln_bwd``)."""
    dgamma = torch.sum(dy * nhat, dim=0, keepdim=True)
    dbeta = torch.sum(dy, dim=0, keepdim=True)
    dn = dy * gamma
    dr = inv * (dn - torch.mean(dn, dim=-1, keepdim=True)
                - nhat * torch.mean(dn * nhat, dim=-1, keepdim=True))
    return dr, dgamma, dbeta


def _gelu_erf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x * 0.7071067811865476))


def _gelu_grad(x: torch.Tensor) -> torch.Tensor:
    """d/dx gelu(x) = Φ(x) + x·φ(x)."""
    return (0.5 * (1.0 + torch.erf(x * 0.7071067811865476))
            + x * torch.exp(-0.5 * x * x) * 0.3989422804014327)


# ---------------------------------------------------------------------------
# Dropout masks: the TPU kernel's counter-based hash, bit for bit
# ---------------------------------------------------------------------------
_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h · c) mod 2**32 for h < 2**32 in int64, without overflowing int64."""
    return (h * (c & 0xFFFF) + (((h * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _hash31(idx: torch.Tensor, seed, tag) -> torch.Tensor:
    """The 31 uniform bits of ``_drop_mask``: murmur3-fmix32 of
    idx ^ (seed + tag·0x9E3779B9), in int64 with every step cut to 32 bits
    (torch's ``>>`` on int32 is arithmetic, and its int32 overflow is not
    promised). ``seed`` and ``tag`` broadcast against ``idx``."""
    h = idx ^ ((seed + tag * _GOLDEN) & _M32)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h & 0x7FFFFFFF


def _keep_threshold(rate: float) -> int:
    """Kept when the hashed 31 bits are below this (computed as the TPU kernel does)."""
    return int((1.0 - rate) * 2147483647.0)


def _keep_scale(rate: float) -> float:
    """float32(1 / (1 − rate)), the value of a kept element of the mask."""
    return float(np.float32(1.0 / (1.0 - rate)))


def _seed_int(seed) -> int:
    return int(seed.reshape(-1)[0]) if isinstance(seed, torch.Tensor) else int(seed)


def _keep(h31: torch.Tensor, rate: float) -> torch.Tensor:
    return (h31 < _keep_threshold(rate)).float() * _keep_scale(rate)


def drop_mask_plain(shape: Tuple[int, int], seed, rate: float, tag: int,
                    device=None) -> torch.Tensor:
    """``_drop_mask(shape, seed, rate, tag)`` (``fused_layer_pallas.py:82``):
    the (rows, cols) f32 keep-mask, 0 or float32(1/(1−rate)), of element
    r·cols + c under the int32 ``seed`` (already folded with the grid step)."""
    rows, cols = shape
    idx = torch.arange(rows * cols, dtype=torch.int64, device=device).reshape(rows, cols)
    return _keep(_hash31(idx, _seed_int(seed) & _M32, tag), rate)


def step_seed(seed, blk):
    """The TPU kernel's per-grid-step seed, seed ^ (blk·0x9E3779B9), as uint32
    (``_step_seed``, :106); ``blk`` an int or an int64 tensor."""
    return ((_seed_int(seed) & _M32) ^ (blk * _GOLDEN)) & _M32


# Site tags of the training forward's own draws (the kernels' sites use 0, 1
# and 16 + ...): the step's base seed, the layer seeds, the embedding mask,
# a key folded with a shard or microbatch index, the nn.Module path's masks
_TAG_STEP, _TAG_LAYERS, _TAG_EMBED, _TAG_FOLD, _TAG_MODULE = 7, 8, 9, 10, 11


def fold_key(key: torch.Tensor, value: int) -> torch.Tensor:
    """A dropout key (seed, step) folded with ``value`` (a data-shard or
    microbatch index), as ``jax.random.fold_in``: → (hash of (seed, value),
    step), an int64 tensor of two on the key's device, made by device
    integer ops alone (a captured graph replays it)."""
    key = key.to(torch.int64)
    seed = _hash31(torch.full_like(key[0:1], value & _M32), key[0:1] & _M32, _TAG_FOLD)
    return torch.cat([seed, key[1:2]])


def module_seed(key: torch.Tensor, layer: int, site: int) -> torch.Tensor:
    """The nn.Module path's seed of one dropout site of one layer under
    dropout key ``key`` = (seed, step): the step's base seed (``step_draws``'s)
    hashed with layer·4 + site, a (1,) int64 tensor on the key's device."""
    key = key.to(torch.int64)
    base = _hash31(key[1:2] & _M32, key[0:1] & _M32, _TAG_STEP)
    return _hash31(torch.full_like(base, (layer * 4 + site) & _M32), base, _TAG_MODULE)


def keep_mask(index: torch.Tensor, seed: torch.Tensor, rate: float) -> torch.Tensor:
    """The bool keep-mask of int32 element indices ``index`` under ``seed``:
    kept when ``_hash31`` of the index falls under the rate's threshold, as
    K1 keeps its own elements."""
    return _hash31_i32(index, seed, 0) < _keep_threshold(rate)


def module_keep_mask_plain(key: torch.Tensor, layer: int, site: int, shape, rate: float,
                           device, heads: Optional[tuple] = None) -> torch.Tensor:
    """``module_keep_mask``'s plain version: ``keep_mask`` of each element's
    index in the whole tensor under ``module_seed(key, layer, site)``."""
    full = list(shape)
    if heads is not None:
        full[1] = heads[1]
    index = torch.arange(math.prod(full), dtype=torch.int32, device=device).reshape(full)
    if heads is not None:
        index = index.narrow(1, heads[0], shape[1])
    return keep_mask(index, module_seed(key.to(device), layer, site), rate)


def module_keep_mask(key: torch.Tensor, layer: int, site: int, shape, rate: float,
                     device, heads: Optional[tuple] = None) -> torch.Tensor:
    """The ``nn.Module`` path's bool keep-mask of dropout site ``site`` of
    layer ``layer`` for a tensor of ``shape`` on ``device``, under dropout
    key ``key`` = (seed, step): element i kept when the 31-bit hash of its
    index under ``module_seed(key, layer, site)`` falls under the rate's
    threshold. ``heads`` = (first head, all heads): the tensor holds heads
    [first, first + shape[1]) of dimension 1, each element indexed by its
    place in the whole tensor (a model shard draws its heads' part of the
    unsharded mask). On a card one launch of ``module_keep_kernel``
    (``fused_layer.cu``) hashes the seed from the key and writes the mask;
    on the CPU, the plain version."""
    device = torch.device(device)
    full = list(shape)
    if heads is not None:
        full[1] = heads[1]
    n = math.prod(full)
    if n >= 2 ** 31:
        raise ValueError(f"a dropout mask of {n} elements does not fit int32 indices")
    if device.type == "cpu":
        return module_keep_mask_plain(key, layer, site, shape, rate, device, heads)
    if device.type != "cuda":
        raise ValueError(f"module_keep_mask runs on cpu or cuda, got {device}")
    from qst_tpu_torch.kernels import build

    out = torch.empty(tuple(shape), dtype=torch.bool, device=device)
    k = key.to(device=device, dtype=torch.int64).contiguous()
    hl = shape[1] if len(shape) > 1 else 1
    rest = math.prod(shape[2:])
    h_all, first = (heads[1], heads[0]) if heads is not None else (hl, 0)
    fn = build.function("qst_module_keep", [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_uint] * 7
                        + [ctypes.c_void_p])
    with build.device_guard(device):
        code = fn(out.data_ptr(), k.data_ptr(), (layer * 4 + site) & _M32, _keep_threshold(rate),
                  out.numel(), hl, rest, h_all, first,
                  torch.cuda.current_stream(device).cuda_stream)
    build.count_launch(module_keep_mask)
    build.check(code, "module_keep_mask")
    return out


module_keep_mask.launches = 0


def step_draws(key: torch.Tensor, num_layers: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward's draws for dropout key ``key`` = (seed, step),
    an int64 tensor of two on the model's device: → (the step's 31-bit base
    seed as a (1,) int64 tensor, the (num_layers, 1) int32 seeds of K1's
    in-kernel masks). Both come from ``_hash31`` on the device — integer ops
    only, no host value and no generator — so a step's draws are a pure
    function of (seed, step), the same whether the step runs eagerly or
    replays from a captured graph."""
    key = key.to(torch.int64)
    base = _hash31(key[1:2] & _M32, key[0:1] & _M32, _TAG_STEP)
    layers = torch.arange(num_layers, dtype=torch.int64, device=key.device)[:, None]
    return base, _hash31(layers, base, _TAG_LAYERS).to(torch.int32)


def _wrap32(c: int) -> int:
    """The int32 with the bits of the uint32 ``c``."""
    return c - (1 << 32) if c & 0x80000000 else c


def _hash31_i32(idx: torch.Tensor, seed: torch.Tensor, tag: int) -> torch.Tensor:
    """``_hash31`` in int32 arithmetic, for an int32 ``idx`` and a (1,) int64
    ``seed``: the same bits at half the bytes a pass and in fewer passes
    (int32 products wrap modulo 2**32; each right shift is masked to make
    it logical). The int64 form stays the reference."""
    s = (seed + tag * _GOLDEN) & _M32
    h = idx ^ ((s ^ 0x80000000) - 0x80000000).to(torch.int32)
    h ^= (h >> 16) & 0xFFFF
    h *= _wrap32(0x85EBCA6B)
    h ^= (h >> 13) & 0x7FFFF
    h *= _wrap32(0xC2B2AE35)
    h ^= (h >> 16) & 0xFFFF
    return h & 0x7FFFFFFF


def embedding_dropout(x: torch.Tensor, base: torch.Tensor, rate: float) -> torch.Tensor:
    """Inverted dropout of the embeddings' output: element i kept when the
    31 bits ``_hash31(i, base, tag)`` fall under the rate's threshold, as
    K1 keeps its own elements, and scaled by float32(1/(1 − rate)). The
    bits come from ``_hash31_i32`` (the (B·S, H) index fits int32)."""
    idx = torch.arange(x.numel(), dtype=torch.int32, device=x.device).reshape(x.shape)
    return (x.float() * _keep(_hash31_i32(idx, base, _TAG_EMBED), rate)).to(x.dtype)


def _hidden_mask(B: int, S: int, H: int, seed, rate: float, nb: int, tag: int,
                 device) -> torch.Tensor:
    """(B·S, H) mask of a hidden-state site (tag 0: attention output, 1: FFN
    output): sequence b is row b % nb of grid step b // nb."""
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)  # noqa: E731
    b, s, c = ar(B)[:, None, None], ar(S)[None, :, None], ar(H)[None, None, :]
    idx = ((b % nb) * S + s) * H + c
    return _keep(_hash31(idx, step_seed(seed, b // nb), tag), rate).reshape(B * S, H)


def _attn_mask(B: int, nh: int, S: int, seed, rate: float, nb: int,
               device) -> torch.Tensor:
    """(B, nh, S, S) mask of the attention probabilities: tag
    16 + (b % nb)·nh + h, element q·S + k."""
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)  # noqa: E731
    b, h = ar(B)[:, None, None, None], ar(nh)[None, :, None, None]
    idx = ar(S)[:, None] * S + ar(S)[None, :]
    return _keep(_hash31(idx, step_seed(seed, b // nb), 16 + (b % nb) * nh + h), rate)


def _check_dropout(attn_dropout: float, hidden_dropout: float, seed) -> bool:
    stoch = attn_dropout > 0.0 or hidden_dropout > 0.0
    if stoch and seed is None:
        raise ValueError("dropout rates > 0 require a seed")
    if not (0.0 <= attn_dropout < 1.0 and 0.0 <= hidden_dropout < 1.0):
        raise ValueError(f"dropout rates must be in [0, 1), got {attn_dropout}, {hidden_dropout}")
    return stoch


# ---------------------------------------------------------------------------
# K1: forward
# ---------------------------------------------------------------------------
def _add_rel(scores: torch.Tensor, rel_bias: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, nh, S, S) logits + the (nh·S, S) relative bias of each head."""
    if rel_bias is None:
        return scores
    nh, S = scores.shape[1], scores.shape[-1]
    return scores + rel_bias.float().reshape(nh, S, S)[None]


def fused_bert_layer_plain(x: torch.Tensor, mask_bias: torch.Tensor,
                           weights: Dict[str, torch.Tensor], *, num_heads: int,
                           rel_bias: Optional[torch.Tensor] = None,
                           eps: float = 1e-12, attn_dropout: float = 0.0,
                           hidden_dropout: float = 0.0, seed=None,
                           nb: int = 8) -> torch.Tensor:
    """Plain PyTorch version of K1: the TPU kernel's body for the whole
    batch at once, with its rounding points (q/k/v after bias, the
    probabilities before P·V, ctx, the LN1 output, the GELU output and the
    layer output round to x.dtype; everything else is f32). Products upcast
    to f32 first, so bf16 operands give exact products with f32 sums.
    Dropout masks are ``_drop_mask``'s, with ``nb`` sequences per grid step.
    ``rel_bias`` (nh·S, S) is added after scale and mask bias."""
    _check_dropout(attn_dropout, hidden_dropout, seed)
    B, S, H = x.shape
    hd = H // num_heads
    dt = x.dtype
    w = {n: weights[n].float() for n in WEIGHT_NAMES}
    x2 = x.reshape(B * S, H).float()

    def proj(wn, bn):
        return (x2 @ w[wn] + w[bn]).to(dt)

    def heads(t):
        return t.float().reshape(B, S, num_heads, hd)

    q, k, v = proj("wq", "bq"), proj("wk", "bk"), proj("wv", "bv")
    scores = torch.einsum("bqhd,bkhd->bhqk", heads(q), heads(k))
    scores = scores * (1.0 / math.sqrt(hd)) + mask_bias.float()[:, None, None, :]
    scores = _add_rel(scores, rel_bias)
    m = torch.amax(scores, dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    p = p / torch.sum(p, dim=-1, keepdim=True)
    if attn_dropout > 0.0:
        p = p * _attn_mask(B, num_heads, S, seed, attn_dropout, nb, x.device)
    ctx = torch.einsum("bhqk,bkhd->bqhd", p.to(dt).float(), heads(v))
    ctx = ctx.reshape(B * S, H).to(dt)
    attn = ctx.float() @ w["wo"] + w["bo"]
    if hidden_dropout > 0.0:
        attn = attn * _hidden_mask(B, S, H, seed, hidden_dropout, nb, 0, x.device)
    y = _layernorm_f32(attn + x2, w["ln1_g"], w["ln1_b"], eps).to(dt)
    inter = _gelu_erf(y.float() @ w["w1"] + w["b1"]).to(dt)
    ffn = inter.float() @ w["w2"] + w["b2"]
    if hidden_dropout > 0.0:
        ffn = ffn * _hidden_mask(B, S, H, seed, hidden_dropout, nb, 1, x.device)
    out = _layernorm_f32(ffn + y.float(), w["ln2_g"], w["ln2_b"], eps)
    return out.to(dt).reshape(B, S, H)


def _qkv_operands(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The kernel's operands: ``wqkv`` = [wq | wk | wv] (H, 3H) and its bias
    ``bqkv`` (1, 3H), taken from the dict when ``layer_weights_from_module``
    cached them, else concatenated here; the other weights as they are."""
    if "wqkv" not in weights:
        weights = dict(weights,
                       wqkv=torch.cat([weights["wq"], weights["wk"], weights["wv"]], 1),
                       bqkv=torch.cat([weights["bq"], weights["bk"], weights["bv"]], 1))
    return {n: weights[n] for n in _KERNEL_OPERANDS}


def _check_cuda_args(x, mask_bias, operands, num_heads, rel_bias=None) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused layer kernel takes float32/bfloat16, got {x.dtype}")
    B, S, H = x.shape
    F = operands["w1"].shape[1]
    hd = H // num_heads
    if S > MAX_SEQ:
        raise NotImplementedError(
            f"fused layer kernel needs S <= {MAX_SEQ} (the 512 positions of BERT and MPNet), "
            f"got {S}")
    if H % num_heads or hd not in HEAD_DIMS:
        raise NotImplementedError(f"fused layer kernel needs head_dim in {HEAD_DIMS}")
    if H % 64 or F % 64 or H > 1024:
        raise ValueError(f"fused layer kernel needs H, F % 64 == 0 and H <= 1024, got {H}, {F}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if (mask_bias.shape != (B, S) or mask_bias.dtype != torch.float32
            or not mask_bias.is_contiguous() or mask_bias.device != x.device):
        raise ValueError("mask_bias must be a contiguous (B, S) float32 tensor on x's device")
    if rel_bias is not None and (
            tuple(rel_bias.shape) != (num_heads * S, S) or rel_bias.dtype != torch.float32
            or not rel_bias.is_contiguous() or rel_bias.device != x.device):
        raise ValueError(f"rel_bias must be a contiguous ({num_heads * S}, {S}) float32 tensor "
                         f"on x's device, got {tuple(rel_bias.shape)} {rel_bias.dtype} on "
                         f"{rel_bias.device}")
    shapes = {"wqkv": (H, 3 * H), "bqkv": (1, 3 * H), "wo": (H, H), "w1": (H, F),
              "w2": (F, H), "b1": (1, F)}
    for n, t in operands.items():
        want_dt = x.dtype if n in _MATRICES else torch.float32
        want_shape = shapes.get(n, (1, H))
        if (t.dtype != want_dt or tuple(t.shape) != want_shape
                or not t.is_contiguous() or t.device != x.device):
            raise ValueError(
                f"weight {n}: need contiguous {want_shape} {want_dt} on {x.device}, "
                f"got {tuple(t.shape)} {t.dtype} on {t.device}")


def _seed_tensor(seed, device) -> torch.Tensor:
    """The seed as the (1,) int32 device tensor the kernels read."""
    if isinstance(seed, torch.Tensor):
        if seed.dtype != torch.int32 or seed.numel() != 1 or seed.device != device:
            raise ValueError(f"seed must be one int32 on {device}, got {seed.dtype} "
                             f"{tuple(seed.shape)} on {seed.device}")
        return seed.reshape(1).contiguous()
    return torch.tensor([np.int32(np.uint32(int(seed) & _M32).view(np.int32))],
                        dtype=torch.int32, device=device)


# (seed pointer, nb, attn on, attn threshold, attn scale, hidden on, threshold, scale)
_DROP_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_float,
                  ctypes.c_int, ctypes.c_uint, ctypes.c_float]


def _drop_args(seed, attn_dropout, hidden_dropout, nb, device):
    """→ (the dropout arguments of a C entry point, the seed tensor to keep alive)."""
    if not _check_dropout(attn_dropout, hidden_dropout, seed):
        return (None, 1, 0, 0, 0.0, 0, 0, 0.0), None
    if nb < 1:
        raise ValueError(f"nb must be >= 1, got {nb}")
    s = _seed_tensor(seed, device)

    def site(rate):
        return (int(rate > 0.0), _keep_threshold(rate) if rate > 0.0 else 0,
                _keep_scale(rate) if rate > 0.0 else 0.0)

    return (s.data_ptr(), nb, *site(attn_dropout), *site(hidden_dropout)), s


def _dtype_code(dt: torch.dtype) -> int:
    from qst_tpu_torch.kernels import build

    return build.DTYPE_CODES[str(dt).removeprefix("torch.")]


_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 21 + [ctypes.c_int] * 5 + [ctypes.c_float]
             + _DROP_ARGTYPES + [ctypes.c_void_p])


def fused_bert_layer(x: torch.Tensor, mask_bias: torch.Tensor,
                     weights: Dict[str, torch.Tensor], *, num_heads: int,
                     rel_bias: torch.Tensor | None = None, eps: float = 1e-12,
                     attn_dropout: float = 0.0, hidden_dropout: float = 0.0,
                     seed=None, nb: int = 8) -> torch.Tensor:
    """One full BERT encoder layer (attention + FFN + layernorms).

    x: (B, S, H); mask_bias: (B, S) f32 (0 attended / -1e9 pad); weights in
    the TPU kernel layout (``WEIGHT_NAMES``): (H, H), (H, F), (F, H)
    matrices in (in, out) order and x's dtype, (1, ·) f32 biases and
    LayerNorm parameters; optionally also ``wqkv``/``bqkv``, the Q, K and V
    weights concatenated as ``layer_weights_from_module`` caches them, so
    the kernel's single QKV product needs no concatenation per call.
    ``attn_dropout``/``hidden_dropout`` > 0 need ``seed``, an int or a (1,)
    int32 tensor on x's device; ``nb`` is the TPU kernel's sequences per
    grid step, which the masks depend on. ``rel_bias``: MPNet's (nh·S, S)
    f32 relative bias (``fused_layer_pallas.py:191``). → (B, S, H) in x.dtype.

    A CPU tensor takes ``fused_bert_layer_plain``; a CUDA tensor launches
    K1 or raises on what it does not take."""
    if x.device.type == "cpu":
        if rel_bias is not None and tuple(rel_bias.shape) != (num_heads * x.shape[1], x.shape[1]):
            raise ValueError(f"rel_bias must be ({num_heads * x.shape[1]}, {x.shape[1]}), "
                             f"got {tuple(rel_bias.shape)}")
        return fused_bert_layer_plain(x, mask_bias, weights, num_heads=num_heads,
                                      rel_bias=rel_bias, eps=eps, attn_dropout=attn_dropout,
                                      hidden_dropout=hidden_dropout, seed=seed, nb=nb)
    if x.device.type != "cuda":
        raise ValueError(f"fused layer runs on cpu or cuda tensors, got {x.device}")
    operands = _qkv_operands(weights)
    _check_cuda_args(x, mask_bias, operands, num_heads, rel_bias)
    drop, seed_t = _drop_args(seed, attn_dropout, hidden_dropout, nb, x.device)
    from qst_tpu_torch.kernels import build

    B, S, H = x.shape
    F = weights["w1"].shape[1]
    M = B * S
    dt = x.dtype
    qkv = torch.empty((M, 3 * H), dtype=dt, device=x.device)
    ctx = torch.empty((M, H), dtype=dt, device=x.device)
    tmp = torch.empty((M, H), dtype=torch.float32, device=x.device)
    y = torch.empty((M, H), dtype=dt, device=x.device)
    inter = torch.empty((M, F), dtype=dt, device=x.device)
    out = torch.empty((B, S, H), dtype=dt, device=x.device)
    fn = build.function("qst_fused_layer_forward", _ARGTYPES)
    with torch.cuda.device(x.device):   # launch into the tensors' device context
        code = fn(_dtype_code(dt), x.data_ptr(), mask_bias.data_ptr(),
                  None if rel_bias is None else rel_bias.data_ptr(),
                  *[operands[n].data_ptr() for n in _KERNEL_OPERANDS],
                  qkv.data_ptr(), ctx.data_ptr(), tmp.data_ptr(), y.data_ptr(),
                  inter.data_ptr(), out.data_ptr(), B, S, H, F, num_heads, eps, *drop,
                  torch.cuda.current_stream(x.device).cuda_stream)
    build.count_launch(fused_bert_layer)
    build.check(code, "fused_bert_layer")
    del seed_t
    return out


fused_bert_layer.launches = 0


def drop_mask(shape: Tuple[int, int], seed, rate: float, tag: int,
              device=None) -> torch.Tensor:
    """``_drop_mask`` on ``device``: on a GPU, K1's and K2's own device
    function writes the mask out (for holding it bit for bit against
    ``drop_mask_plain``); on the CPU, the plain version."""
    device = torch.device(device if device is not None else "cpu")
    if device.type == "cpu":
        return drop_mask_plain(shape, seed, rate, tag)
    if device.type != "cuda":
        raise ValueError(f"drop_mask runs on cpu or cuda, got {device}")
    if not 0.0 < rate < 1.0:
        raise ValueError(f"rate must be in (0, 1), got {rate}")
    from qst_tpu_torch.kernels import build

    rows, cols = shape
    out = torch.empty((rows, cols), dtype=torch.float32, device=device)
    s = _seed_tensor(seed, device)
    fn = build.function("qst_drop_mask", [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                          ctypes.c_void_p, ctypes.c_uint, ctypes.c_float,
                                          ctypes.c_uint, ctypes.c_void_p])
    with torch.cuda.device(device):
        code = fn(out.data_ptr(), rows, cols, s.data_ptr(), _keep_threshold(rate),
                  _keep_scale(rate), tag, torch.cuda.current_stream(device).cuda_stream)
    build.count_launch(drop_mask)
    build.check(code, "drop_mask")
    return out


drop_mask.launches = 0


# ---------------------------------------------------------------------------
# The layer's bf16 GEMM alone
# ---------------------------------------------------------------------------
def layer_gemm_plain(a: torch.Tensor, b: torch.Tensor, *, trans_a: bool = False,
                     trans_b: bool = False) -> torch.Tensor:
    """Plain version of ``layer_gemm``: op(a) @ op(b) in f32 of the same
    operands (bf16 products are exact in f32; the sums are f32)."""
    a, b = a.float(), b.float()
    return (a.T if trans_a else a) @ (b.T if trans_b else b)


def layer_gemm(a: torch.Tensor, b: torch.Tensor, *, trans_a: bool = False,
               trans_b: bool = False, splits: int = 1) -> torch.Tensor:
    """The one GEMM behind all of K1's and K2's products, alone: (M, N) f32
    = op(a) @ op(b) for bf16 ``a`` stored (M, K), or (K, M) with
    ``trans_a`` (a weight gradient's xᵀ·dy), and ``b`` stored (K, N), or
    (N, K) with ``trans_b`` (an input gradient's dy·Wᵀ); ``splits`` > 1 cuts
    K into f32 partials summed in a fixed order. It exists so each operand
    layout can be held against a plain product by itself.

    A CPU tensor takes ``layer_gemm_plain``; a CUDA tensor launches the
    kernel or raises."""
    if a.device.type == "cpu":
        return layer_gemm_plain(a, b, trans_a=trans_a, trans_b=trans_b)
    if a.device.type != "cuda":
        raise ValueError(f"layer_gemm runs on cpu or cuda tensors, got {a.device}")
    for t in (a, b):
        if (t.dtype != torch.bfloat16 or t.dim() != 2 or not t.is_contiguous()
                or t.device != a.device or t.shape[1] % 8):
            raise ValueError("layer_gemm takes contiguous 2-d bfloat16 tensors on one device "
                             "whose rows are a multiple of 8 values")
    K, M = a.shape if trans_a else a.shape[::-1]
    N, Kb = b.shape if trans_b else b.shape[::-1]
    if K != Kb or splits < 1:
        raise ValueError(f"layer_gemm: inner sizes {K} and {Kb}, splits {splits}")
    from qst_tpu_torch.kernels import build

    ws = torch.empty((splits, M, N), dtype=torch.float32, device=a.device)
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    fn = build.function("qst_layer_gemm_bf16", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                        + [ctypes.c_void_p])
    with torch.cuda.device(a.device):
        code = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), ws.data_ptr(), M, N, K,
                  int(trans_a), int(trans_b), splits,
                  torch.cuda.current_stream(a.device).cuda_stream)
    build.count_launch(layer_gemm)
    build.check(code, "layer_gemm")
    return out


layer_gemm.launches = 0


# ---------------------------------------------------------------------------
# K2: backward
# ---------------------------------------------------------------------------
def fused_bert_layer_bwd_plain(x: torch.Tensor, mask_bias: torch.Tensor,
                               weights: Dict[str, torch.Tensor], g: torch.Tensor, *,
                               num_heads: int, rel_bias: Optional[torch.Tensor] = None,
                               eps: float = 1e-12, attn_dropout: float = 0.0,
                               hidden_dropout: float = 0.0, seed=None, nb: int = 8
                               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Plain PyTorch version of K2 (``_layer_bwd_kernel``, :345): recompute
    the forward from x, then the chain rule, for the whole batch at once.
    The TPU kernel's rounding points to x.dtype are kept: the forward's, and
    df, dipre, da, dctx, the dropped probabilities, dS·scale and dq/dk/dv
    before their products; bias gradients sum the f32 values.
    → (dx (B, S, H) in x.dtype, {weight name: f32 gradient}); with
    ``rel_bias`` the dict also holds ``drel`` (nh·S, S), the logits'
    gradient before the scale summed over the batch (:470-474)."""
    _check_dropout(attn_dropout, hidden_dropout, seed)
    B, S, H = x.shape
    nh, hd, M, dt = num_heads, H // num_heads, B * S, x.dtype
    scale = 1.0 / math.sqrt(hd)
    w = {n: weights[n].float() for n in WEIGHT_NAMES}
    x2 = x.reshape(M, H).float()

    def rnd(t):
        return t.to(dt).float()

    def heads(t):    # (M, H) → (B, nh, S, hd)
        return t.reshape(B, S, nh, hd).transpose(1, 2)

    def unheads(t):  # (B, nh, S, hd) → (M, H)
        return t.transpose(1, 2).reshape(M, H)

    m_attn = (_attn_mask(B, nh, S, seed, attn_dropout, nb, x.device)
              if attn_dropout > 0.0 else None)
    m_out, m_ffn = ((_hidden_mask(B, S, H, seed, hidden_dropout, nb, t, x.device)
                     for t in (0, 1)) if hidden_dropout > 0.0 else (None, None))

    # ---- forward recompute
    q, k, v = (rnd(x2 @ w[f"w{n}"] + w[f"b{n}"]) for n in "qkv")
    scores = heads(q) @ heads(k).transpose(-1, -2) * scale + mask_bias.float()[:, None, None, :]
    scores = _add_rel(scores, rel_bias)
    p = torch.exp(scores - torch.amax(scores, dim=-1, keepdim=True))
    p = p / torch.sum(p, dim=-1, keepdim=True)
    p_dt = rnd(p * m_attn if m_attn is not None else p)
    ctx = rnd(unheads(p_dt @ heads(v)))
    a = ctx @ w["wo"] + w["bo"]
    if m_out is not None:
        a = a * m_out
    n1, inv1 = _ln_stats(a + x2, eps)
    y = rnd(n1 * w["ln1_g"] + w["ln1_b"])
    ipre = y @ w["w1"] + w["b1"]
    i_dt = rnd(_gelu_erf(ipre))
    f = i_dt @ w["w2"] + w["b2"]
    if m_ffn is not None:
        f = f * m_ffn
    n2, inv2 = _ln_stats(f + y, eps)

    # ---- backward chain
    dr2, dg2, dbe2 = _ln_bwd(g.reshape(M, H).float(), n2, inv2, w["ln2_g"])
    df = dr2 * m_ffn if m_ffn is not None else dr2
    df_dt = rnd(df)
    dipre = (df_dt @ w["w2"].T) * _gelu_grad(ipre)
    dipre_dt = rnd(dipre)
    dy = dr2 + dipre_dt @ w["w1"].T
    dr1, dg1, dbe1 = _ln_bwd(dy, n1, inv1, w["ln1_g"])
    da = dr1 * m_out if m_out is not None else dr1
    da_dt = rnd(da)
    dc_dt = heads(rnd(da_dt @ w["wo"].T))
    dv = p_dt.transpose(-1, -2) @ dc_dt
    dp = dc_dt @ heads(v).transpose(-1, -2)
    if m_attn is not None:
        dp = dp * m_attn
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    dss_dt = rnd(ds * scale)
    d = {"q": unheads(dss_dt @ heads(k)), "k": unheads(dss_dt.transpose(-1, -2) @ heads(q)),
         "v": unheads(dv)}
    grads = dict(wo=ctx.T @ da_dt, bo=da.sum(0, keepdim=True), ln1_g=dg1, ln1_b=dbe1,
                 w1=y.T @ dipre_dt, b1=dipre.sum(0, keepdim=True), w2=i_dt.T @ df_dt,
                 b2=df.sum(0, keepdim=True), ln2_g=dg2, ln2_b=dbe2)
    dx = dr1
    for n in "qkv":
        d_dt = rnd(d[n])
        grads[f"w{n}"] = x2.T @ d_dt
        grads[f"b{n}"] = d[n].sum(0, keepdim=True)
        dx = dx + d_dt @ w[f"w{n}"].T
    out = {n: grads[n] for n in WEIGHT_NAMES}
    if rel_bias is not None:
        out["drel"] = ds.sum(0).reshape(nh * S, S)
    return dx.to(dt).reshape(B, S, H), out


_BWD_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 24 + [ctypes.c_int] * 5
                 + [ctypes.c_float] + _DROP_ARGTYPES + [ctypes.c_void_p])


def fused_bert_layer_bwd(x: torch.Tensor, mask_bias: torch.Tensor,
                         weights: Dict[str, torch.Tensor], g: torch.Tensor, *,
                         num_heads: int, rel_bias: Optional[torch.Tensor] = None,
                         eps: float = 1e-12, attn_dropout: float = 0.0,
                         hidden_dropout: float = 0.0, seed=None, nb: int = 8
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """K2: the layer's backward given the upstream gradient ``g`` (B, S, H)
    in x.dtype — the forward recomputed from x, dropout masks regenerated
    from ``seed``. → (dx in x.dtype, {weight name: f32 gradient}), the dict
    with ``drel`` (nh·S, S) f32 when ``rel_bias`` is given.

    A CPU tensor takes ``fused_bert_layer_bwd_plain``; a CUDA tensor
    launches K2 or raises."""
    kw = dict(num_heads=num_heads, rel_bias=rel_bias, eps=eps, attn_dropout=attn_dropout,
              hidden_dropout=hidden_dropout, seed=seed, nb=nb)
    if x.device.type == "cpu":
        return fused_bert_layer_bwd_plain(x, mask_bias, weights, g, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"fused layer runs on cpu or cuda tensors, got {x.device}")
    operands = _qkv_operands(weights)
    _check_cuda_args(x, mask_bias, operands, num_heads, rel_bias)
    if g.shape != x.shape or g.dtype != x.dtype or not g.is_contiguous() or g.device != x.device:
        raise ValueError("g must be a contiguous tensor of x's shape, dtype and device")
    drop, seed_t = _drop_args(seed, attn_dropout, hidden_dropout, nb, x.device)
    from qst_tpu_torch.kernels import build

    B, S, H = x.shape
    F = weights["w1"].shape[1]
    dev, f32 = x.device, torch.float32
    code = _dtype_code(x.dtype)
    has_rel = rel_bias is not None
    ws_bytes = build.function("qst_fused_layer_backward_workspace", [ctypes.c_int] * 7,
                              ctypes.c_size_t)(code, B, S, H, F, num_heads, int(has_rel))
    ws = torch.empty(ws_bytes, dtype=torch.uint8, device=dev)
    dx = torch.empty_like(x)
    dwqkv = torch.empty((H, 3 * H), dtype=f32, device=dev)
    dwo = torch.empty((H, H), dtype=f32, device=dev)
    dw1 = torch.empty((H, F), dtype=f32, device=dev)
    dw2 = torch.empty((F, H), dtype=f32, device=dev)
    dvec = torch.empty(9 * H + F, dtype=f32, device=dev)
    drel = torch.empty((num_heads * S, S), dtype=f32, device=dev) if has_rel else None
    fn = build.function("qst_fused_layer_backward", _BWD_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(code, x.data_ptr(), mask_bias.data_ptr(),
                 *[operands[n].data_ptr() for n in _KERNEL_OPERANDS],
                 rel_bias.data_ptr() if has_rel else None, g.data_ptr(),
                 dx.data_ptr(), dwqkv.data_ptr(), dwo.data_ptr(), dw1.data_ptr(),
                 dw2.data_ptr(), dvec.data_ptr(), drel.data_ptr() if has_rel else None,
                 ws.data_ptr(), B, S, H, F, num_heads, eps,
                 *drop, torch.cuda.current_stream(dev).cuda_stream)
    build.count_launch(fused_bert_layer_bwd)
    build.check(err, "fused_bert_layer_bwd")
    del seed_t

    def vec(lo, n):
        return dvec[lo:lo + n].reshape(1, n)

    grads = dict(wq=dwqkv[:, :H], wk=dwqkv[:, H:2 * H], wv=dwqkv[:, 2 * H:], wo=dwo,
                 w1=dw1, w2=dw2, bq=vec(0, H), bk=vec(H, H), bv=vec(2 * H, H),
                 ln1_g=vec(3 * H, H), ln1_b=vec(4 * H, H), bo=vec(5 * H, H), b1=vec(6 * H, F),
                 ln2_g=vec(6 * H + F, H), ln2_b=vec(7 * H + F, H), b2=vec(8 * H + F, H))
    out = {n: grads[n] for n in WEIGHT_NAMES}
    if has_rel:
        out["drel"] = drel
    return dx, out


fused_bert_layer_bwd.launches = 0


class FusedBertLayer(torch.autograd.Function):
    """The differentiable fused layer (``_make_diff_layer``, :587): forward
    K1, backward K2. Only the layer input is saved (remat): K2 recomputes the
    forward and regenerates the dropout masks from the seed. Matrix gradients
    come back in the weights' dtype, as JAX casts ``dw`` (:614), so an f32
    parameter behind a bf16 weight receives a bf16-rounded gradient.

    ``apply(x, mask_bias, seed, opts, *weights[, rel_bias])`` with ``opts`` =
    (num_heads, eps, attn_dropout, hidden_dropout, nb), the 16 weights in
    ``WEIGHT_NAMES`` order and, for MPNet, the (nh·S, S) relative bias last,
    whose gradient is K2's ``drel``."""

    @staticmethod
    def forward(ctx, x, mask_bias, seed, opts, *inputs):
        num_heads, eps, attn_dropout, hidden_dropout, nb = opts
        weights, rel = inputs[:len(WEIGHT_NAMES)], inputs[len(WEIGHT_NAMES):]
        ctx.save_for_backward(x, mask_bias, *inputs)
        ctx.seed, ctx.opts = seed, opts
        return fused_bert_layer(x, mask_bias, dict(zip(WEIGHT_NAMES, weights)),
                                num_heads=num_heads, rel_bias=rel[0] if rel else None, eps=eps,
                                attn_dropout=attn_dropout, hidden_dropout=hidden_dropout,
                                seed=seed, nb=nb)

    @staticmethod
    def backward(ctx, g):
        x, mask_bias, *inputs = ctx.saved_tensors
        num_heads, eps, attn_dropout, hidden_dropout, nb = ctx.opts
        weights, rel = inputs[:len(WEIGHT_NAMES)], inputs[len(WEIGHT_NAMES):]
        rel_bias = rel[0] if rel else None
        w = dict(zip(WEIGHT_NAMES, weights))
        dx, dw = fused_bert_layer_bwd(x, mask_bias, w, g.contiguous(), num_heads=num_heads,
                                      rel_bias=rel_bias, eps=eps, attn_dropout=attn_dropout,
                                      hidden_dropout=hidden_dropout, seed=ctx.seed, nb=nb)
        drel = (dw["drel"].to(rel_bias.dtype),) if rel else ()
        return (dx, None, None, None, *[dw[n].to(w[n].dtype) for n in WEIGHT_NAMES], *drel)


def _attention_parts(layer: torch.nn.Module):
    """(q, k, v, o, attention LayerNorm) of a ``BertLayer`` or an
    ``MPNetLayer`` (``layer_weights_from_params``' two name sets, :675)."""
    att = layer.attention
    if hasattr(att, "attn"):    # MPNet: attention.attn.{q,k,v,o}, attention.LayerNorm
        return att.attn.q, att.attn.k, att.attn.v, att.attn.o, att.LayerNorm
    return (att.self.query, att.self.key, att.self.value, att.output.dense,
            att.output.LayerNorm)


def layer_weights_for_training(layer: torch.nn.Module,
                               dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """One ``BertLayer``'s or ``MPNetLayer``'s weights in the kernel layout,
    made anew on each call so gradients flow from ``FusedBertLayer`` back to
    the ``nn.Parameter``s through the transpose and the cast (the JAX
    package's autodiff of ``layer_weights_from_params``). HF ``Linear``
    weights are (out, in); the kernel takes (in, out) in the compute dtype;
    vectors are (1, n) f32. A tensor-parallel layer (``models/bert.py``
    ``TensorParallelLayer``) gathers its shards' slices here, so the
    gradients flow back to each slice."""
    if hasattr(layer, "kernel_weights"):
        return layer.kernel_weights(dtype)
    q, k, v, o, ln1 = _attention_parts(layer)
    ffn_in, ffn_out = layer.intermediate, layer.output

    def mat(lin):
        return lin.weight.t().to(dtype).contiguous()

    def vec(t):
        return t.reshape(1, -1).float().contiguous()

    return dict(
        wq=mat(q), bq=vec(q.bias), wk=mat(k), bk=vec(k.bias), wv=mat(v), bv=vec(v.bias),
        wo=mat(o), bo=vec(o.bias), ln1_g=vec(ln1.weight), ln1_b=vec(ln1.bias),
        w1=mat(ffn_in.dense), b1=vec(ffn_in.dense.bias),
        w2=mat(ffn_out.dense), b2=vec(ffn_out.dense.bias),
        ln2_g=vec(ffn_out.LayerNorm.weight), ln2_b=vec(ffn_out.LayerNorm.bias),
    )


def layer_weights_from_module(layer: torch.nn.Module,
                              dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """One ``BertLayer``'s or ``MPNetLayer``'s weights in the kernel layout, made
    once and cached on the layer (counterpart of
    ``layer_weights_from_params``, ``fused_layer_pallas.py:658``), for the
    encode path: detached, no gradient flows through them.

    The dict also holds ``wqkv`` (H, 3H) and ``bqkv`` (1, 3H), the operands
    of the kernel's one QKV product. The cache is keyed by the dtype and
    every parameter's storage and in-place version, so loading new weights,
    moving the module, casting or an optimizer step invalidates it; a batch
    never transposes or concatenates again."""
    params = list(layer.parameters())
    key = (dtype, tuple((p.data_ptr(), p._version) for p in params))
    cached = layer.__dict__.get("_kernel_weights")
    if cached is not None and cached[0] == key:
        return cached[1]
    with torch.no_grad():
        w = {n: t.detach() for n, t in layer_weights_for_training(layer, dtype).items()}
        w.update(wqkv=torch.cat([w["wq"], w["wk"], w["wv"]], 1),
                 bqkv=torch.cat([w["bq"], w["bk"], w["bv"]], 1))
    layer.__dict__["_kernel_weights"] = (key, w)
    return w



def fused_encoder_forward(cfg: EncoderConfig, model: torch.nn.Module,
                          input_ids: torch.Tensor, attention_mask: torch.Tensor, *,
                          differentiable: bool = False,
                          dropout_key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ids/mask → last hidden state (B, S, H) through the fused layer
    (``fused_layer_pallas.py:695``), for BERT and MPNet.

    The embeddings (a gather plus LayerNorm) stay plain torch, as they stay
    XLA in the TPU version; each transformer layer is one ``fused_bert_layer``
    call, or with ``differentiable`` one ``FusedBertLayer`` (K1 forward, K2
    backward). The GPU needs no batch padding to a block multiple. MPNet
    (:724-749): padding-aware positions, no token types, and the shared
    relative-bias table gathered once per call into (nh·S, S), its gradient
    (K2's ``drel`` of every layer) flowing back to the table through that
    gather. Both MPNet gathers (positions, bias table) have backward passes
    of their own that give the same bits on every run (``models/mpnet.py``).

    ``dropout_key``: when given and the config has dropout, the training
    forward of step (seed, step) = ``dropout_key`` (two int64 values, moved
    to the ids' device): embedding dropout in plain torch and one int32 seed
    per layer for the in-kernel masks of attention probabilities, attention
    output and FFN output, all derived on the device by ``step_draws`` (their
    bits are not ``jax.random``'s)."""
    if cfg.arch not in ("bert", "mpnet"):
        # qst_tpu/ops/fused_layer_pallas.py:713-715 refuses RoBERTa the same way
        raise ValueError(f"fused layer supports arch='bert'/'mpnet', {cfg.arch} given")
    dt = getattr(torch, cfg.dtype)
    train = dropout_key is not None and (cfg.hidden_dropout > 0 or cfg.attention_dropout > 0)
    attn_drop = cfg.attention_dropout if train else 0.0
    hid_drop = cfg.hidden_dropout if train else 0.0
    emb = model.embeddings
    S = input_ids.shape[1]
    # the embedding lookup, not an index: its backward sums repeated ids in
    # a fixed order (an index's backward adds them atomically on the CPU)
    # and splits a long run of one id (the padding) across blocks (an
    # index's backward on the card sums each id's run in one thread block)
    word = torch.nn.functional.embedding(input_ids.long(), emb.word_embeddings.weight).to(dt)
    rel_bias = None
    if cfg.arch == "mpnet":
        from qst_tpu_torch.models.mpnet import position_embeddings, relative_bias

        summed = word + position_embeddings(input_ids.long(), emb.position_embeddings.weight,
                                            cfg.pad_token_id).to(dt)
        rel_bias = relative_bias(model.encoder.relative_attention_bias.weight, S)
        rel_bias = rel_bias.reshape(cfg.num_heads * S, S).contiguous()
        if not differentiable:
            rel_bias = rel_bias.detach()
    else:
        pos = emb.position_embeddings.weight[:S].to(dt)[None]
        typ = emb.token_type_embeddings.weight[0].to(dt)[None, None]
        summed = word + pos + typ
    x = _layernorm_f32(summed.float(), emb.LayerNorm.weight.float(),
                       emb.LayerNorm.bias.float(), cfg.layer_norm_eps).to(dt)
    mask_bias = torch.where(attention_mask > 0, 0.0, MASK_BIAS).float().contiguous()
    seeds = None
    if train:
        base, seeds = step_draws(dropout_key.to(x.device), cfg.num_layers)
        if cfg.hidden_dropout > 0:
            x = embedding_dropout(x, base, cfg.hidden_dropout)
    x = x.contiguous()
    for i, layer in enumerate(model.encoder.layer):
        seed = seeds[i] if train else None
        if differentiable:
            w = layer_weights_for_training(layer, dt)
            opts = (cfg.num_heads, cfg.layer_norm_eps, attn_drop, hid_drop, cfg.fused_nb)
            rel = (rel_bias,) if rel_bias is not None else ()
            x = FusedBertLayer.apply(x, mask_bias, seed, opts,
                                     *[w[n] for n in WEIGHT_NAMES], *rel)
        else:
            x = fused_bert_layer(x, mask_bias, layer_weights_from_module(layer, dt),
                                 num_heads=cfg.num_heads, rel_bias=rel_bias,
                                 eps=cfg.layer_norm_eps,
                                 attn_dropout=attn_drop, hidden_dropout=hid_drop, seed=seed,
                                 nb=cfg.fused_nb)
    return x


def fused_embed_fn(cfg: EncoderConfig, *, differentiable: bool = False,
                   with_dropout: bool = False) -> Callable:
    """The fused-path forward: (model, ids, mask) → (B, D) embeddings, a
    drop-in for ``models.sentence_encoder.embed_fn`` on the encode path
    (``fused_layer_pallas.py:816``). ``differentiable``: the training trunk,
    gradients through K2 (otherwise the forward runs under ``no_grad``).
    ``with_dropout``: the function takes a trailing ``dropout_key`` (seed,
    step) and applies the config's dropout rates."""
    from qst_tpu_torch.ops.distances import l2_normalize
    from qst_tpu_torch.ops.pooling import POOLERS

    def fwd(model, input_ids, attention_mask, dropout_key=None):
        with contextlib.nullcontext() if differentiable else torch.no_grad():
            hidden = fused_encoder_forward(cfg, model, input_ids, attention_mask,
                                           differentiable=differentiable,
                                           dropout_key=dropout_key)
            pooled = POOLERS[cfg.pooling](hidden, attention_mask)
            if cfg.normalize:
                pooled = l2_normalize(pooled)
        return pooled

    if with_dropout:
        return fwd
    return lambda model, input_ids, attention_mask: fwd(model, input_ids, attention_mask)
