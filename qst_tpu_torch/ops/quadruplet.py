"""K3: the fused γ-quadruplet loss — counterpart of
``qst_tpu/ops/quadruplet_pallas.py``.

Replaces the TPU kernel ``_kernel`` (``quadruplet_pallas.py:33``) behind
``_forward`` (``:64``), and the jnp backward of its custom VJP (``:124``):
``kernels/csrc/quadruplet.cu`` holds both as hand-written CUDA, one warp per
row and one launch each way. The forward gives each example's loss, its
(B, 3) distances [d(a,p), d(a,t), d(a,n)], ‖x − y + 1e-6‖₂, and the reduced
loss (sum or mean, added up in a fixed order inside the kernel); the backward
gives the four input gradients from the saved distances and the upstream
gradient where autograd left it on the device. p = 2 without swap only, as
``LossConfig(use_fused_kernel=True)`` enforces. What bounds it (launches and
host calls, not bytes) and what the design does about it is in the CUDA
file's header.

``fused_gamma_quadruplet_loss_fwd`` and ``_bwd`` take their plain versions
(``fused_gamma_quadruplet_loss_plain``, ``fused_gamma_quadruplet_loss_bwd_plain``)
only for tensors on the CPU; a CUDA tensor launches the kernel or raises.
Each counts its launches in ``.launches``. ``fused_gamma_quadruplet_loss``
is the autograd function over the two.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from qst_tpu_torch.core.config import DEFAULT_GAMMA

_EPS = 1e-6
_REDUCTIONS = {"none": 0, "sum": 1, "mean": 2}


@functools.lru_cache(maxsize=64)
def _consts(gamma: float) -> Tuple[float, float]:
    """γ and 1 − γ as the kernel multiplies them: float32 of the Python value."""
    return float(np.float32(gamma)), float(np.float32(1.0 - gamma))


def _check_reduction(reduction: str) -> None:
    if reduction not in _REDUCTIONS:
        raise ValueError(f"reduction must be mean, sum or none, {reduction} given")


def _scale_const(reduction: str, B: int) -> float:
    """What a sum's or a mean's upstream gradient is multiplied by."""
    return float(np.float32(1.0 / B)) if reduction == "mean" else 1.0


def fused_gamma_quadruplet_loss_plain(a, p, t, n, *, gamma: float, m_pn: float, m_pt: float,
                                      m_tn: float, reduction: str = "none"
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel (``_kernel``, :33): → (loss,
    distances (B, 3) = [d(a,p), d(a,t), d(a,n)]), f32; the loss is (B,) per
    example, or their sum or mean as a scalar."""
    _check_reduction(reduction)
    a, p, t, n = (x.float() for x in (a, p, t, n))

    def dist(x, y):
        d = x - y + _EPS
        return torch.sqrt(torch.sum(d * d, dim=1))

    d_ap, d_at, d_an = dist(a, p), dist(a, t), dist(a, n)
    g, w_c = _consts(gamma)
    la = torch.clamp_min(d_ap - d_an + m_pn, 0.0)
    lb = torch.clamp_min(d_at - d_an + m_tn, 0.0)
    lc = torch.clamp_min(d_ap - d_at + m_pt, 0.0)
    loss = la + g * lb + w_c * lc
    if reduction != "none":
        loss = loss.mean() if reduction == "mean" else loss.sum()
    return loss, torch.stack([d_ap, d_at, d_an], dim=1)


def fused_gamma_quadruplet_loss_bwd_plain(a, p, t, n, dists, scale, *, gamma: float,
                                          m_pn: float, m_pt: float, m_tn: float,
                                          reduction: str = "none"):
    """Plain version of the backward kernel (the jnp VJP, :124-160): the
    gradients w.r.t. a, p, t, n from the saved distances, for the upstream
    gradient ``scale``: (B,), one value an example's loss, or for a sum or a
    mean the scalar gradient of the reduced loss. → (da, dp, dt, dn), f32."""
    _check_reduction(reduction)
    a, p, t, n = (x.float() for x in (a, p, t, n))
    d_ap, d_at, d_an = dists[:, 0:1], dists[:, 1:2], dists[:, 2:3]
    u_ap = (a - p + _EPS) / torch.clamp_min(d_ap, 1e-12)
    u_at = (a - t + _EPS) / torch.clamp_min(d_at, 1e-12)
    u_an = (a - n + _EPS) / torch.clamp_min(d_an, 1e-12)
    act_a = (d_ap - d_an + m_pn > 0).float()
    act_b = (d_at - d_an + m_tn > 0).float()
    act_c = (d_ap - d_at + m_pt > 0).float()
    g, w_c = _consts(gamma)
    if reduction == "none":
        s = scale.float()[:, None]
    else:
        s = (_scale_const(reduction, a.shape[0]) * scale.float()).reshape(1, 1)
    c_ap = (act_a + w_c * act_c) * s
    c_at = (g * act_b - w_c * act_c) * s
    c_an = (-act_a - g * act_b) * s
    da = c_ap * u_ap + c_at * u_at + c_an * u_an
    return da, -c_ap * u_ap, -c_at * u_at, -c_an * u_an


def _f32c(x: torch.Tensor) -> torch.Tensor:
    """x as contiguous float32; itself when it already is (a slice of the
    (4B, D) embeddings is), with no call into the dispatcher."""
    return x if x.dtype == torch.float32 and x.is_contiguous() else x.float().contiguous()


def _check_cuda(*xs: torch.Tensor) -> None:
    """a, p, t, n: contiguous f32 (B, D) of one shape on one card."""
    ref = xs[0]
    if ref.device.type != "cuda":
        raise ValueError(f"quadruplet loss runs on cpu or cuda tensors, got {ref.device}")
    if ref.dim() != 2 or any(x.shape != ref.shape or x.device != ref.device for x in xs):
        raise ValueError("a, p, t, n must be (B, D) of one shape on one device, got "
                         + ", ".join(f"{tuple(x.shape)} on {x.device}" for x in xs))


_FWD_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_float] * 5
                 + [ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_float] * 6
                 + [ctypes.c_void_p])
# a sum or a mean of up to this many rows is taken by one block; above it the
# rows spread over the card and the launch gets a zeroed counter of its own
# (one more fill on the device), by which the last block to finish adds up
_ONE_BLOCK_ROWS = 256


def _launch_fwd(rows, B: int, D: int, device, reduction: str, gamma, m_pn, m_pt, m_tn):
    """The forward kernel over the four (B, D) f32 row blocks at the addresses
    ``rows``: → (loss, distances (B, 3)), parts of one buffer."""
    from qst_tpu_torch.kernels import build

    # one buffer: the distances, the per-example losses, the reduced loss
    buf = torch.empty(4 * B + 1, dtype=torch.float32, device=device)
    base = buf.data_ptr()
    counter = (torch.zeros(1, dtype=torch.int32, device=device)
               if reduction != "none" and B > _ONE_BLOCK_ROWS else None)
    g, w_c = _consts(gamma)
    fn = build.function("qst_quadruplet_forward", _FWD_ARGTYPES)
    with build.device_guard(device):
        code = fn(*rows, base + 12 * B, base, base + 16 * B,
                  None if counter is None else counter.data_ptr(), B, D,
                  _REDUCTIONS[reduction], g, w_c, m_pn, m_pt, m_tn,
                  torch.cuda.current_stream(device).cuda_stream)
    build.count_launch(fused_gamma_quadruplet_loss_fwd)
    build.check(code, "qst_quadruplet_forward")
    return (buf[3 * B:4 * B] if reduction == "none" else buf[4 * B]), buf[:3 * B].view(B, 3)


def _launch_bwd(rows, dists, scale, B: int, D: int, reduction: str, gamma, m_pn, m_pt, m_tn):
    """The backward kernel over the same row blocks: → (4, B, D) f32 =
    [da, dp, dt, dn]."""
    dists, scale = _f32c(dists), _f32c(scale)
    if (dists.shape != (B, 3) or scale.numel() != (B if reduction == "none" else 1)
            or not dists.is_cuda or scale.device != dists.device):
        raise ValueError("dists must be (B, 3) and the upstream gradient (B,) for reduction "
                         "'none', one value otherwise, on the embeddings' device")
    from qst_tpu_torch.kernels import build

    grads = torch.empty((4, B, D), dtype=torch.float32, device=dists.device)
    g, w_c = _consts(gamma)
    fn = build.function("qst_quadruplet_backward", _BWD_ARGTYPES)
    with build.device_guard(dists.device):
        code = fn(*rows, dists.data_ptr(), scale.data_ptr(), grads.data_ptr(), B, D,
                  int(reduction == "none"), _scale_const(reduction, B), g, w_c, m_pn, m_pt,
                  m_tn, torch.cuda.current_stream(dists.device).cuda_stream)
    build.count_launch(fused_gamma_quadruplet_loss_bwd)
    build.check(code, "qst_quadruplet_backward")
    return grads


def _cuda_rows(a, p, t, n):
    """The four embeddings as contiguous f32 on one card → (their addresses,
    B, D, the tensors that own the memory)."""
    xs = tuple(_f32c(x) for x in (a, p, t, n))
    _check_cuda(*xs)
    return [x.data_ptr() for x in xs], xs[0].shape[0], xs[0].shape[1], xs


def fused_gamma_quadruplet_loss_fwd(a, p, t, n, *, gamma: float, m_pn: float, m_pt: float,
                                    m_tn: float, reduction: str = "none"
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 forward, one launch: → (loss, distances (B, 3)), f32; the loss is
    (B,) per example, or the scalar sum or mean the kernel reduced itself."""
    _check_reduction(reduction)
    if a.device.type == "cpu":
        return fused_gamma_quadruplet_loss_plain(a, p, t, n, gamma=gamma, m_pn=m_pn, m_pt=m_pt,
                                                 m_tn=m_tn, reduction=reduction)
    rows, B, D, xs = _cuda_rows(a, p, t, n)
    return _launch_fwd(rows, B, D, xs[0].device, reduction, gamma, m_pn, m_pt, m_tn)


fused_gamma_quadruplet_loss_fwd.launches = 0


def fused_gamma_quadruplet_loss_bwd(a, p, t, n, dists, scale, *, gamma: float, m_pn: float,
                                    m_pt: float, m_tn: float, reduction: str = "none"):
    """K3 backward, one launch: → (da, dp, dt, dn), f32 (the four parts of
    one (4, B, D) buffer), for the upstream gradient ``scale``: (B,) for
    reduction "none", else the scalar gradient of the sum or the mean."""
    _check_reduction(reduction)
    if a.device.type == "cpu":
        return fused_gamma_quadruplet_loss_bwd_plain(
            a, p, t, n, dists, scale, gamma=gamma, m_pn=m_pn, m_pt=m_pt, m_tn=m_tn,
            reduction=reduction)
    rows, B, D, _ = _cuda_rows(a, p, t, n)
    return _launch_bwd(rows, dists, scale, B, D, reduction, gamma, m_pn, m_pt, m_tn).unbind(0)


fused_gamma_quadruplet_loss_bwd.launches = 0


class _FusedQuadrupletLoss(torch.autograd.Function):
    """The custom VJP of ``fused_gamma_quadruplet_loss`` (:92): forward K3,
    backward K3's second kernel from the saved distances."""

    @staticmethod
    def forward(ctx, a, p, t, n, consts, reduction):
        gamma, m_pn, m_pt, m_tn = consts
        loss, dists = fused_gamma_quadruplet_loss_fwd(
            a, p, t, n, gamma=gamma, m_pn=m_pn, m_pt=m_pt, m_tn=m_tn, reduction=reduction)
        ctx.save_for_backward(a, p, t, n, dists)
        ctx.consts, ctx.reduction = consts, reduction
        return loss

    @staticmethod
    def backward(ctx, g):
        a, p, t, n, dists = ctx.saved_tensors
        gamma, m_pn, m_pt, m_tn = ctx.consts
        grads = fused_gamma_quadruplet_loss_bwd(a, p, t, n, dists, g, gamma=gamma, m_pn=m_pn,
                                                m_pt=m_pt, m_tn=m_tn, reduction=ctx.reduction)
        return (*[d if d.dtype == x.dtype else d.to(x.dtype)
                  for d, x in zip(grads, (a, p, t, n))], None, None)


def fused_gamma_quadruplet_loss(x_anchor, x_pos, x_part, x_neg, gamma: float = DEFAULT_GAMMA,
                                margin_pos_neg: float = 1.0, margin_pos_part: float = 0.5,
                                margin_part_neg: float = 0.5,
                                reduction: str = "mean") -> torch.Tensor:
    """Fused γ-quadruplet loss (p=2, swap=False), differentiable through K3.
    For p ≠ 2 or swap use ``qst_tpu_torch.ops.losses.gamma_quadruplet_loss``."""
    _check_reduction(reduction)
    return _FusedQuadrupletLoss.apply(
        x_anchor, x_pos, x_part, x_neg,
        (gamma, margin_pos_neg, margin_pos_part, margin_part_neg), reduction)
