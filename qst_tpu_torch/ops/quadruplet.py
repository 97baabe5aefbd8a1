"""K3: the fused γ-quadruplet loss — counterpart of
``qst_tpu/ops/quadruplet_pallas.py``.

Replaces the TPU kernel ``_kernel`` (``quadruplet_pallas.py:33``) behind
``_forward`` (``:64``), and the jnp backward of its custom VJP (``:124``):
``kernels/csrc/quadruplet.cu`` holds both as hand-written CUDA, one warp per
row. The forward gives each example's loss and its (B, 3) distances
[d(a,p), d(a,t), d(a,n)], ‖x − y + 1e-6‖₂; the backward gives the four
input gradients from the saved distances. p = 2 without swap only, as
``LossConfig(use_fused_kernel=True)`` enforces. What bounds it and what the
design does about it is in the CUDA file's header.

``fused_gamma_quadruplet_loss_fwd`` and ``_bwd`` take their plain versions
(``fused_gamma_quadruplet_loss_plain``, ``fused_gamma_quadruplet_loss_bwd_plain``)
only for tensors on the CPU; a CUDA tensor launches the kernel or raises.
Each counts its launches in ``.launches``. ``fused_gamma_quadruplet_loss``
is the autograd function over the two.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from qst_tpu_torch.core.config import DEFAULT_GAMMA

_EPS = 1e-6


def _consts(gamma: float) -> Tuple[float, float]:
    """γ and 1 − γ as the kernel multiplies them: float32 of the Python value."""
    return float(np.float32(gamma)), float(np.float32(1.0 - gamma))


def fused_gamma_quadruplet_loss_plain(a, p, t, n, *, gamma: float, m_pn: float, m_pt: float,
                                      m_tn: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel (``_kernel``, :33): → (per-example
    loss (B,), distances (B, 3) = [d(a,p), d(a,t), d(a,n)]), f32."""
    a, p, t, n = (x.float() for x in (a, p, t, n))

    def dist(x, y):
        d = x - y + _EPS
        return torch.sqrt(torch.sum(d * d, dim=1))

    d_ap, d_at, d_an = dist(a, p), dist(a, t), dist(a, n)
    g, w_c = _consts(gamma)
    la = torch.clamp_min(d_ap - d_an + m_pn, 0.0)
    lb = torch.clamp_min(d_at - d_an + m_tn, 0.0)
    lc = torch.clamp_min(d_ap - d_at + m_pt, 0.0)
    return la + g * lb + w_c * lc, torch.stack([d_ap, d_at, d_an], dim=1)


def fused_gamma_quadruplet_loss_bwd_plain(a, p, t, n, dists, scale, *, gamma: float,
                                          m_pn: float, m_pt: float, m_tn: float):
    """Plain version of the backward kernel (the jnp VJP, :124-160): the
    gradients of Σ scale[i]·loss[i] w.r.t. a, p, t, n from the saved
    distances. → (da, dp, dt, dn), f32."""
    a, p, t, n = (x.float() for x in (a, p, t, n))
    d_ap, d_at, d_an = dists[:, 0:1], dists[:, 1:2], dists[:, 2:3]
    u_ap = (a - p + _EPS) / torch.clamp_min(d_ap, 1e-12)
    u_at = (a - t + _EPS) / torch.clamp_min(d_at, 1e-12)
    u_an = (a - n + _EPS) / torch.clamp_min(d_an, 1e-12)
    act_a = (d_ap - d_an + m_pn > 0).float()
    act_b = (d_at - d_an + m_tn > 0).float()
    act_c = (d_ap - d_at + m_pt > 0).float()
    g, w_c = _consts(gamma)
    s = scale.float()[:, None]
    c_ap = (act_a + w_c * act_c) * s
    c_at = (g * act_b - w_c * act_c) * s
    c_an = (-act_a - g * act_b) * s
    da = c_ap * u_ap + c_at * u_at + c_an * u_an
    return da, -c_ap * u_ap, -c_at * u_at, -c_an * u_an


def _check_cuda(*ts: torch.Tensor) -> None:
    ref = ts[0]
    for x in ts:
        if (x.dtype != torch.float32 or not x.is_contiguous() or x.device != ref.device
                or x.shape[0] != ref.shape[0]):
            raise ValueError("quadruplet kernel takes contiguous float32 tensors of one "
                             f"batch on one device, got {x.dtype} {tuple(x.shape)} on {x.device}")
    if ref.dim() != 2 or any(x.shape != ref.shape for x in ts[:4]):
        raise ValueError("a, p, t, n must be (B, D) of one shape")


def _launch(name: str, ptrs, B: int, D: int, gamma, m_pn, m_pt, m_tn, device) -> None:
    from qst_tpu_torch.kernels import build

    g, w_c = _consts(gamma)
    fn = build.function(name, [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 2
                        + [ctypes.c_float] * 5 + [ctypes.c_void_p])
    with torch.cuda.device(device):
        code = fn(*ptrs, B, D, g, w_c, m_pn, m_pt, m_tn,
                  torch.cuda.current_stream(device).cuda_stream)
    build.check(code, name)


def fused_gamma_quadruplet_loss_fwd(a, p, t, n, *, gamma: float, m_pn: float, m_pt: float,
                                    m_tn: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 forward: → (per-example loss (B,), distances (B, 3)), f32."""
    kw = dict(gamma=gamma, m_pn=m_pn, m_pt=m_pt, m_tn=m_tn)
    if a.device.type == "cpu":
        return fused_gamma_quadruplet_loss_plain(a, p, t, n, **kw)
    if a.device.type != "cuda":
        raise ValueError(f"quadruplet loss runs on cpu or cuda tensors, got {a.device}")
    a, p, t, n = (x.float().contiguous() for x in (a, p, t, n))
    _check_cuda(a, p, t, n)
    B, D = a.shape
    loss = torch.empty(B, dtype=torch.float32, device=a.device)
    dists = torch.empty((B, 3), dtype=torch.float32, device=a.device)
    _launch("qst_quadruplet_forward", [x.data_ptr() for x in (a, p, t, n, loss, dists)], B, D,
            gamma, m_pn, m_pt, m_tn, a.device)
    fused_gamma_quadruplet_loss_fwd.launches += 1
    return loss, dists


fused_gamma_quadruplet_loss_fwd.launches = 0


def fused_gamma_quadruplet_loss_bwd(a, p, t, n, dists, scale, *, gamma: float, m_pn: float,
                                    m_pt: float, m_tn: float):
    """K3 backward: → (da, dp, dt, dn), f32, for upstream ``scale`` (B,)."""
    kw = dict(gamma=gamma, m_pn=m_pn, m_pt=m_pt, m_tn=m_tn)
    if a.device.type == "cpu":
        return fused_gamma_quadruplet_loss_bwd_plain(a, p, t, n, dists, scale, **kw)
    if a.device.type != "cuda":
        raise ValueError(f"quadruplet loss runs on cpu or cuda tensors, got {a.device}")
    a, p, t, n = (x.float().contiguous() for x in (a, p, t, n))
    dists, scale = dists.contiguous(), scale.float().contiguous()
    _check_cuda(a, p, t, n, dists, scale)
    if dists.shape != (a.shape[0], 3) or scale.shape != (a.shape[0],):
        raise ValueError("dists must be (B, 3) and scale (B,)")
    B, D = a.shape
    grads = [torch.empty_like(a) for _ in range(4)]
    _launch("qst_quadruplet_backward",
            [x.data_ptr() for x in (a, p, t, n, dists, scale, *grads)], B, D, gamma, m_pn,
            m_pt, m_tn, a.device)
    fused_gamma_quadruplet_loss_bwd.launches += 1
    return tuple(grads)


fused_gamma_quadruplet_loss_bwd.launches = 0


class _FusedQuadrupletLoss(torch.autograd.Function):
    """The custom VJP of ``fused_gamma_quadruplet_loss`` (:92): forward K3,
    backward K3's second kernel from the saved distances."""

    @staticmethod
    def forward(ctx, a, p, t, n, consts, reduction):
        gamma, m_pn, m_pt, m_tn = consts
        per_example, dists = fused_gamma_quadruplet_loss_fwd(
            a, p, t, n, gamma=gamma, m_pn=m_pn, m_pt=m_pt, m_tn=m_tn)
        ctx.save_for_backward(a, p, t, n, dists)
        ctx.consts, ctx.reduction = consts, reduction
        if reduction == "mean":
            return per_example.mean()
        if reduction == "sum":
            return per_example.sum()
        return per_example

    @staticmethod
    def backward(ctx, g):
        a, p, t, n, dists = ctx.saved_tensors
        gamma, m_pn, m_pt, m_tn = ctx.consts
        B = a.shape[0]
        if ctx.reduction == "mean":
            scale = torch.full((B,), 1.0 / B, device=a.device) * g
        elif ctx.reduction == "sum":
            scale = torch.ones((B,), device=a.device) * g
        else:
            scale = g
        grads = fused_gamma_quadruplet_loss_bwd(a, p, t, n, dists, scale, gamma=gamma,
                                                m_pn=m_pn, m_pt=m_pt, m_tn=m_tn)
        return (*[d.to(x.dtype) for d, x in zip(grads, (a, p, t, n))], None, None)


def fused_gamma_quadruplet_loss(x_anchor, x_pos, x_part, x_neg, gamma: float = DEFAULT_GAMMA,
                                margin_pos_neg: float = 1.0, margin_pos_part: float = 0.5,
                                margin_part_neg: float = 0.5,
                                reduction: str = "mean") -> torch.Tensor:
    """Fused γ-quadruplet loss (p=2, swap=False), differentiable through K3.
    For p ≠ 2 or swap use ``qst_tpu_torch.ops.losses.gamma_quadruplet_loss``."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be mean, sum or none, {reduction} given")
    return _FusedQuadrupletLoss.apply(
        x_anchor, x_pos, x_part, x_neg,
        (gamma, margin_pos_neg, margin_pos_part, margin_part_neg), reduction)
