"""Quadruplet losses — counterpart of ``qst_tpu/ops/losses.py``.

- ``triplet_margin_loss(a, p, n, margin, p_norm, swap)`` =
  ``max(d(a,p) - d(a,n) + margin, 0)`` with the eps-in-difference distance;
  ``swap`` uses ``d_n = min(d(a,n), d(p,n))``, as torch's
  ``F.triplet_margin_loss``.
- ``gamma_quadruplet_loss``:
  ``L = T(a,pos,neg; m_pn) + γ·T(a,part,neg; m_tn) + (1-γ)·T(a,pos,part; m_pt)``
  with each term reduced in the source's association order (``_reduce3``).
- ``d_regularized_quadruplet_loss``:
  ``T(a,pos,neg) + T(a,part,neg) - λ·[BCE(D(a,pos),1) + BCE(D(a,part),0)]``.

Plain torch, differentiable by autograd; the fused kernel for the
p=2/no-swap γ loss is ``ops/quadruplet.py`` (K3).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from qst_tpu_torch.core.config import DEFAULT_GAMMA, REDUCTIONS
from qst_tpu_torch.ops.distances import pairwise_distance


def _validate_common(p: float, reduction: str) -> None:
    if p <= 0:
        raise ValueError(f"p must be positive, {p} given")
    if reduction not in REDUCTIONS:
        raise ValueError(
            f"reduction must be one of: {sorted(REDUCTIONS)}, {reduction} given"
        )


def _validate_margins(**margins: float) -> None:
    for name, m in margins.items():
        if m <= 0:
            raise ValueError(f"{name} must be positive, {m} given")


def triplet_margin_loss(anchor: torch.Tensor, positive: torch.Tensor,
                        negative: torch.Tensor, margin: float = 1.0, p: float = 2.0,
                        swap: bool = False, eps: float = 1e-6) -> torch.Tensor:
    """Per-example (unreduced) triplet margin loss, shape (B,)."""
    d_pos = pairwise_distance(anchor, positive, p=p, eps=eps)
    d_neg = pairwise_distance(anchor, negative, p=p, eps=eps)
    if swap:
        d_swap = pairwise_distance(positive, negative, p=p, eps=eps)
        d_neg = torch.minimum(d_neg, d_swap)
    return torch.clamp_min(d_pos - d_neg + margin, 0.0)


def _reduce3(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, gamma: float,
             reduction: str) -> torch.Tensor:
    # each term reduced on its own, in the source's association order
    if reduction == "none":
        return a + gamma * b + (1.0 - gamma) * c
    if reduction == "sum":
        return a.sum() + (gamma * b).sum() + ((1.0 - gamma) * c).sum()
    return a.mean() + (gamma * b).mean() + ((1.0 - gamma) * c).mean()


def gamma_quadruplet_loss(x_anchor: torch.Tensor, x_pos: torch.Tensor,
                          x_part: torch.Tensor, x_neg: torch.Tensor,
                          gamma: float = DEFAULT_GAMMA, margin_pos_neg: float = 1.0,
                          margin_pos_part: float = 0.5, margin_part_neg: float = 0.5,
                          p: float = 2.0, swap: bool = False,
                          reduction: str = "mean") -> torch.Tensor:
    """γ-quadruplet loss (reference losses.py:9-69)."""
    if gamma < 0 or gamma > 1:
        raise ValueError(f"gamma must be between 0 and 1, {gamma} given")
    _validate_margins(margin_pos_neg=margin_pos_neg, margin_pos_part=margin_pos_part,
                      margin_part_neg=margin_part_neg)
    _validate_common(p, reduction)
    a = triplet_margin_loss(x_anchor, x_pos, x_neg, margin_pos_neg, p, swap)
    b = triplet_margin_loss(x_anchor, x_part, x_neg, margin_part_neg, p, swap)
    c = triplet_margin_loss(x_anchor, x_pos, x_part, margin_pos_part, p, swap)
    return _reduce3(a, b, c, gamma, reduction)


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable elementwise BCE-with-logits (torch semantics)."""
    return (torch.clamp_min(logits, 0.0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))


def d_regularized_quadruplet_loss(
    x_anchor: torch.Tensor, x_pos: torch.Tensor, x_part: torch.Tensor, x_neg: torch.Tensor,
    margin_pos_neg: float = 1.0, margin_part_neg: float = 1.0, lmbd: float = 0.1,
    discr: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
    discr_logits_pos: Optional[torch.Tensor] = None,
    discr_logits_part: Optional[torch.Tensor] = None,
    p: float = 2.0, swap: bool = False, reduction: str = "mean",
) -> torch.Tensor:
    """Discriminator-regularized quadruplet loss (reference losses.py:72-151).

    ``a + b - λ·[BCE(D(anchor,pos)=1) + BCE(D(anchor,part)=0)]``; logits may
    be supplied directly or computed by ``discr(anchor, x)`` → (B, 1)."""
    if lmbd <= 0:
        raise ValueError(f"lmbd must be positive, {lmbd} given")
    _validate_margins(margin_pos_neg=margin_pos_neg, margin_part_neg=margin_part_neg)
    _validate_common(p, reduction)
    if discr is None and (discr_logits_pos is None or discr_logits_part is None):
        raise ValueError("Either discriminator or discriminator logits must be given")

    a = triplet_margin_loss(x_anchor, x_pos, x_neg, margin_pos_neg, p, swap)
    b = triplet_margin_loss(x_anchor, x_part, x_neg, margin_part_neg, p, swap)
    if discr_logits_pos is None or discr_logits_part is None:
        discr_logits_pos = discr(x_anchor, x_pos)
        discr_logits_part = discr(x_anchor, x_part)
    lp = discr_logits_pos.reshape(discr_logits_pos.shape[0], -1)
    lt = discr_logits_part.reshape(discr_logits_part.shape[0], -1)
    bce = (bce_with_logits(lp, torch.ones_like(lp))
           + bce_with_logits(lt, torch.zeros_like(lt))).squeeze(-1)
    if reduction == "none":
        return a + b - lmbd * bce
    if reduction == "sum":
        return a.sum() + b.sum() - lmbd * bce.sum()
    return a.mean() + b.mean() - lmbd * bce.mean()


class GammaQuadrupletLoss:
    """Configured callable mirroring the reference's ``GammaQuadrupletLoss``
    module (losses.py:241-303), with the same constructor validation."""

    def __init__(self, gamma: float = DEFAULT_GAMMA, margin_pos_neg: float = 1.0,
                 margin_pos_part: float = 1.0, margin_part_neg: float = 1.0,
                 p: float = 2.0, swap: bool = False, reduction: str = "mean"):
        if gamma < 0 or gamma > 1:
            raise ValueError(f"gamma must be between 0 and 1, {gamma} given")
        _validate_margins(margin_pos_neg=margin_pos_neg, margin_pos_part=margin_pos_part,
                          margin_part_neg=margin_part_neg)
        _validate_common(p, reduction)
        self.gamma = gamma
        self.margin_pos_neg = margin_pos_neg
        self.margin_pos_part = margin_pos_part
        self.margin_part_neg = margin_part_neg
        self.p = p
        self.swap = swap
        self.reduction = reduction

    def __call__(self, x_anchor, x_pos, x_part, x_neg,
                 reduction: Optional[str] = None, **kwargs) -> torch.Tensor:
        return gamma_quadruplet_loss(
            x_anchor, x_pos, x_part, x_neg, gamma=self.gamma,
            margin_pos_neg=self.margin_pos_neg, margin_pos_part=self.margin_pos_part,
            margin_part_neg=self.margin_part_neg, p=self.p, swap=self.swap,
            reduction=self.reduction if reduction is None else reduction)


class DRegularizedQuadrupletLoss:
    """Configured callable for the discriminator-regularized variant."""

    def __init__(self, margin_pos_neg: float = 1.0, margin_part_neg: float = 1.0,
                 lmbd: float = 0.1, p: float = 2.0, swap: bool = False,
                 reduction: str = "mean"):
        if lmbd <= 0:
            raise ValueError(f"lmbd must be positive, {lmbd} given")
        _validate_margins(margin_pos_neg=margin_pos_neg, margin_part_neg=margin_part_neg)
        _validate_common(p, reduction)
        self.margin_pos_neg = margin_pos_neg
        self.margin_part_neg = margin_part_neg
        self.lmbd = lmbd
        self.p = p
        self.swap = swap
        self.reduction = reduction

    def __call__(self, x_anchor, x_pos, x_part, x_neg, discr=None,
                 discr_logits_pos=None, discr_logits_part=None,
                 reduction: Optional[str] = None, **kwargs) -> torch.Tensor:
        return d_regularized_quadruplet_loss(
            x_anchor, x_pos, x_part, x_neg, margin_pos_neg=self.margin_pos_neg,
            margin_part_neg=self.margin_part_neg, lmbd=self.lmbd, discr=discr,
            discr_logits_pos=discr_logits_pos, discr_logits_part=discr_logits_part,
            p=self.p, swap=self.swap,
            reduction=self.reduction if reduction is None else reduction)
