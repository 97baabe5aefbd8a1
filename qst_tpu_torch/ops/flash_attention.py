"""K7 and K8: flash attention with segment ids — counterpart of the library
kernel behind ``EncoderConfig.use_flash_attention``.

qst_tpu calls ``jax.experimental.pallas.ops.tpu.flash_attention.flash_attention``
at ``qst_tpu/models/bert.py:87-101``; it reaches ``pl.pallas_call`` three
times (``flash_attention.py:758`` forward, ``:1121`` dK/dV, ``:1456`` dQ,
with di = Σ o·dO in XLA at ``:254-275``). ``kernels/csrc/flash_attention.cu``
holds both directions as hand-written CUDA for Hopper (wgmma fed by TMA,
warp-specialised): K7 the forward, one sweep over the keys; K8 the backward,
a statistics pre-pass then one sweep over the key blocks that computes each
logit's exponential once. The function is the library's, rounding points
included: see the CUDA file's header for the two that moved by f32 ulps.

- ``flash_attention(q, k, v, seg_q, seg_kv, sm_scale)``: K7. q, k, v are
  (B, nh, S, hd) in any strides with d contiguous (the port's (B, S, nh, hd)
  activations transposed are taken as they lie); ``seg_q``/``seg_kv`` (B, S)
  integers; → o in q's dtype (with ``return_stats`` also the row statistics
  (m, l), (B, nh, S) f32 each). S must be a multiple of 128 (the library's
  block), hd 16, 32 or 64 in bf16, a multiple of 8 up to 64 in f32.
- ``flash_attention_bwd``: K8, → (dq, dk, dv).
- ``FlashAttention``: the autograd function over the two.

A CPU tensor takes the plain versions (``flash_attention_plain``,
``flash_attention_bwd_plain``: the library's semantics in torch, the online
softmax over blocks of 128 keys written out); a CUDA tensor launches the
kernel or raises. Each wrapper counts its launches in ``.launches``: one a
call, however many CUDA kernels the call runs.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

# the library's DEFAULT_MASK_VALUE (flash_attention.py:29) as the f32 its
# kernels add
MASK_VALUE = float(np.float32(-0.7 * float(np.finfo(np.float32).max)))
BLOCK = 128          # the library's block_k: the online softmax's key block
HEAD_DIMS_BF16 = (16, 32, 64)


def _f32(x: float) -> float:
    return float(np.float32(x))


def _check(q, k, v, seg_q, seg_kv) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be (B, nh, S, hd) of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, _, S, _ = q.shape
    if seg_q.shape != (B, S) or seg_kv.shape != (B, S):
        raise ValueError(f"seg_q and seg_kv must be ({B}, {S}), got {tuple(seg_q.shape)} "
                         f"and {tuple(seg_kv.shape)}")
    if S % BLOCK != 0:
        raise ValueError(f"flash attention needs S a multiple of {BLOCK}, got {S}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k, v must share one dtype")


def _logits(q, k, seg_q, seg_kv, sm_scale: float) -> torch.Tensor:
    """(B, nh, S, S) f32: (q·kᵀ)·sm_scale + the segment mask, in the
    library's order."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * _f32(sm_scale)
    same = seg_q[:, None, :, None] == seg_kv[:, None, None, :]
    return s + torch.where(same, 0.0, MASK_VALUE)


def flash_attention_plain(q, k, v, seg_q, seg_kv, sm_scale: float, return_stats: bool = False):
    """Plain version of K7: the library's forward (``mha_reference``'s
    function with the kernel's rounding points). One key block (S = 128):
    p = e^(s-m)/l cast to v's dtype; more: the online softmax over blocks of
    128 keys, p unnormalised in v's dtype and the f32 accumulator rescaled
    by α·l_prev/l_next after each block (``flash_attention.py:453-473``)."""
    _check(q, k, v, seg_q, seg_kv)
    s = _logits(q, k, seg_q, seg_kv, sm_scale)
    S = q.shape[2]
    if S == BLOCK:
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True)
        p = p / l
        out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    else:
        m = torch.full(s.shape[:-1] + (1,), -float("inf"), dtype=torch.float32, device=s.device)
        l = torch.zeros_like(m)
        out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        for k0 in range(0, S, BLOCK):
            sb = s[..., k0:k0 + BLOCK]
            m_next = torch.maximum(m, sb.amax(-1, keepdim=True))
            p = torch.exp(sb - m_next)
            l_corr = torch.exp(m - m_next) * l
            l_next = p.sum(-1, keepdim=True) + l_corr
            inv = torch.where(l_next == 0.0, 1.0, 1.0 / l_next)
            out = out * (l_corr * inv)
            o_curr = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(),
                                  v[..., k0:k0 + BLOCK, :].float())
            out = out + o_curr * inv
            m, l = m_next, l_next
    out = out.to(q.dtype)
    if return_stats:
        return out, m[..., 0], l[..., 0]
    return out


def flash_attention_bwd_plain(q, k, v, seg_q, seg_kv, o, m, l, do, sm_scale: float
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K8: the library's backward
    (``flash_attention.py:254-275, 820-905, 1177-1255``): p = e^(s-m)·(1/l),
    di = Σ o·dO, dS = ((dP - di)∘p)·sm_scale; dV, dK from pᵀ and dSᵀ in dO's
    dtype, dQ from dS in k's dtype, products summed in f32."""
    _check(q, k, v, seg_q, seg_kv)
    scale = _f32(sm_scale)
    p = torch.exp(_logits(q, k, seg_q, seg_kv, sm_scale) - m[..., None]) * (1.0 / l)[..., None]
    dof = do.float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).float(), dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, v.float())
    di = (o.float() * dof).sum(-1)
    ds = ((dp - di[..., None]) * p) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(do.dtype).float(), q.float())
    dq = torch.einsum("bhqk,bhkd->bhqd", ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


_FWD_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                 + [ctypes.c_longlong] * 3 + [ctypes.c_float] * 2 + [ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4
                 + [ctypes.c_longlong] * 3 + [ctypes.c_float] * 2 + [ctypes.c_void_p])


def _kernel_layout(q: torch.Tensor) -> torch.Tensor:
    """q itself where the kernels can read it as it lies (d contiguous,
    16-byte rows and strides, a layout ``empty_like`` keeps), else a
    contiguous copy."""
    itemsize = q.element_size()
    if (q.stride(-1) == 1 and q.data_ptr() % 16 == 0
            and all((s * itemsize) % 16 == 0 for s in q.stride()[:-1])
            and torch.empty_like(q).stride() == q.stride()):
        return q
    return q.contiguous()


def _as_layout(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """x in ``like``'s strides (the kernels take one set for every operand)."""
    if x.stride() == like.stride() and x.data_ptr() % 16 == 0:
        return x
    return torch.empty_like(like).copy_(x)


def _aligned_ids(seg: torch.Tensor) -> torch.Tensor:
    """Segment ids as contiguous int32 on a 16-byte boundary (K7 reads a
    block's ids as int4)."""
    seg = seg.to(torch.int32).contiguous()
    return seg if seg.data_ptr() % 16 == 0 else seg.clone()


def _cuda_args(q, k, v, seg_q, seg_kv):
    """The operands as the kernels take them → (q, k, v, seg_q, seg_kv,
    dtype code, strides (sb, sh, ss))."""
    from qst_tpu_torch.kernels import build

    _check(q, k, v, seg_q, seg_kv)
    if any(t.device != q.device for t in (k, v, seg_q, seg_kv)):
        raise ValueError("q, k, v and the segment ids must lie on one device")
    hd = q.shape[-1]
    if q.dtype == torch.bfloat16:
        if hd not in HEAD_DIMS_BF16:
            raise ValueError(f"bf16 flash attention takes hd in {HEAD_DIMS_BF16}, got {hd}")
    elif q.dtype == torch.float32:
        if hd % 8 or hd > 64:
            raise ValueError(f"f32 flash attention takes hd a multiple of 8 up to 64, got {hd}")
    else:
        raise ValueError(f"flash attention runs in float32 or bfloat16, got {q.dtype}")
    q = _kernel_layout(q)
    k, v = _as_layout(k, q), _as_layout(v, q)
    seg_q, seg_kv = _aligned_ids(seg_q), _aligned_ids(seg_kv)
    code = build.DTYPE_CODES[str(q.dtype).split(".")[-1]]
    return q, k, v, seg_q, seg_kv, code, tuple(q.stride()[:-1])


def flash_attention(q, k, v, seg_q, seg_kv, sm_scale: float, return_stats: bool = False):
    """K7: softmax((q·kᵀ)·sm_scale + segment mask)·v → o in q's strides and
    dtype; with ``return_stats`` → (o, m, l), the row statistics (B, nh, S)
    f32 the backward reads. A CPU tensor takes ``flash_attention_plain``."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, seg_q, seg_kv, sm_scale, return_stats)
    from qst_tpu_torch.kernels import build

    q, k, v, seg_q, seg_kv, code, (sb, sh, ss) = _cuda_args(q, k, v, seg_q, seg_kv)
    B, nh, S, hd = q.shape
    o = torch.empty_like(q)
    stats = torch.empty((2, B, nh, S), dtype=torch.float32, device=q.device)
    fn = build.function("qst_flash_forward", _FWD_ARGTYPES)
    with build.device_guard(q.device):
        err = fn(code, q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_q.data_ptr(),
                 seg_kv.data_ptr(), o.data_ptr(), stats.data_ptr(), B, nh, S, hd, sb, sh, ss,
                 _f32(sm_scale), MASK_VALUE, torch.cuda.current_stream(q.device).cuda_stream)
    build.count_launch(flash_attention)
    build.check(err, "qst_flash_forward")
    if return_stats:
        return o, stats[0], stats[1]
    return o


flash_attention.launches = 0


def flash_attention_bwd(q, k, v, seg_q, seg_kv, o, m, l, do, sm_scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K8: (dq, dk, dv) in q's dtype from the forward's o and (m, l) and the
    upstream gradient ``do``; two CUDA kernels (bf16: the statistics
    pre-pass, then dQ, dK and dV in one sweep; f32: dQ with di, then dK/dV)
    and a scratch buffer, counted as one launch. A CPU tensor takes
    ``flash_attention_bwd_plain``."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, seg_q, seg_kv, o, m, l, do, sm_scale)
    from qst_tpu_torch.kernels import build

    q, k, v, seg_q, seg_kv, code, (sb, sh, ss) = _cuda_args(q, k, v, seg_q, seg_kv)
    B, nh, S, hd = q.shape
    if o.dtype != q.dtype or do.shape != q.shape or o.shape != q.shape:
        raise ValueError("o and do must be q's shape and dtype")
    o, do = _as_layout(o, q), _as_layout(do.to(q.dtype), q)
    stats = torch.stack([m.float(), l.float()]).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    fn = build.function("qst_flash_backward", _BWD_ARGTYPES)
    with build.device_guard(q.device):
        scratch = torch.empty(build.function("qst_flash_backward_scratch_bytes",
                                             [ctypes.c_int] * 5, ctypes.c_longlong)(
                                                 code, B, nh, S, hd),
                              dtype=torch.uint8, device=q.device)
        err = fn(code, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                 seg_q.data_ptr(), seg_kv.data_ptr(), stats.data_ptr(), scratch.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, nh, S, hd, sb, sh, ss,
                 _f32(sm_scale), MASK_VALUE, torch.cuda.current_stream(q.device).cuda_stream)
    build.count_launch(flash_attention_bwd)
    build.check(err, "qst_flash_backward")
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """``FlashAttention.apply(q, k, v, seg_q, seg_kv, sm_scale)`` → o: K7
    forward, K8 backward (their plain versions on the CPU); no gradient for
    the segment ids. Each call of the backward runs once (no double
    backward, as the library's custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_kv, sm_scale):
        o, m, l = flash_attention(q, k, v, seg_q, seg_kv, sm_scale, return_stats=True)
        ctx.save_for_backward(q, k, v, seg_q, seg_kv, o, m, l)
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg_q, seg_kv, o, m, l = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, seg_q, seg_kv, o, m, l, do, ctx.sm_scale)
        return dq, dk, dv, None, None, None
