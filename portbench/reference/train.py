"""The training recipe in plain float32: γ-quadruplet loss, warmuplinear,
clipped AdamW (decoupled weight decay on every tensor), one step at a time.

Loss (the reference repository's ``losses.py``):
``mean T(a, pos, neg; 1.0) + γ·mean T(a, part, neg; 0.5) + (1 − γ)·mean T(a, pos, part; 0.5)``,
``T(a, x, y; m) = max(d(a, x) − d(a, y) + m, 0)``, ``d(u, v) = ‖u − v + 1e-6‖₂``.

Optimizer: the global gradient norm clipped to ``max_grad_norm`` (scaled
only when it reaches it), then Adam moments (β 0.9, 0.999, ε 1e-8) with bias
correction, the update ``m̂/(√v̂ + ε) + wd·p`` scaled by −lr(count before the
update); lr from warmuplinear: linear from 0 over the warm-up, then linear
to 0 at the last step.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from portbench.reference.encoder import embed


def _dist(u, v):
    return torch.sqrt(((u - v + 1e-6) ** 2).sum(-1))


def gamma_loss(a, pos, part, neg, gamma: float, m_pn: float, m_pt: float,
               m_tn: float) -> torch.Tensor:
    t1 = torch.clamp_min(_dist(a, pos) - _dist(a, neg) + m_pn, 0.0)
    t2 = torch.clamp_min(_dist(a, part) - _dist(a, neg) + m_tn, 0.0)
    t3 = torch.clamp_min(_dist(a, pos) - _dist(a, part) + m_pt, 0.0)
    return t1.mean() + gamma * t2.mean() + (1.0 - gamma) * t3.mean()


def warmuplinear(lr: float, warmup: int, total: int, count: int) -> float:
    w = max(1, min(warmup, max(total - 1, 1)))
    if count < w:
        return lr * count / w
    decay = max(1, total - w)
    c = min(max(count - w, 0), decay)
    return lr * (1 - c / decay)


class Trainer:
    """Parameters and moments as named f32 tensors; ``step`` runs one batch."""

    def __init__(self, cfg: Mapping, recipe: Mapping, sd: Mapping[str, torch.Tensor],
                 total_steps: int, precision: str = "f32", half_batch: bool = False,
                 start: Optional[Tuple[Mapping, Mapping, int]] = None):
        """``half_batch``: a planted fault, the loss's mean over the first
        half of the batch alone. ``start``: (first moments, second moments,
        count) to resume from, else zeros and 0."""
        self.cfg, self.recipe, self.total, self.precision = cfg, recipe, total_steps, precision
        self.half_batch = half_batch
        self.params = {k: v.detach().clone().float().requires_grad_(True) for k, v in sd.items()}
        if start is None:
            start = ({k: torch.zeros_like(v) for k, v in self.params.items()},
                     {k: torch.zeros_like(v) for k, v in self.params.items()}, 0)
        mu, nu, self.count = start
        self.mu = {k: mu[k].detach().clone().float() for k in self.params}
        self.nu = {k: nu[k].detach().clone().float() for k in self.params}
        self.first_grads: Dict[str, torch.Tensor] = {}

    def loss(self, ids: torch.Tensor, mask: torch.Tensor, run_seed: int, step: int) -> torch.Tensor:
        """(4, B, S) ids and mask → the batch's loss, the masks of train step ``step``."""
        four, B, S = ids.shape
        r = self.recipe
        emb = embed(self.cfg, self.params, ids.reshape(four * B, S), mask.reshape(four * B, S),
                    self.precision, dropout=(run_seed, step, r["dropout_block"]))
        a, pos, part, neg = emb.reshape(four, B, -1)[:, :B // 2 if self.half_batch else B].unbind(0)
        return gamma_loss(a, pos, part, neg, r["gamma"], r["margin_pos_neg"],
                          r["margin_pos_part"], r["margin_part_neg"])

    def step(self, ids: torch.Tensor, mask: torch.Tensor, run_seed: int, step: int) -> float:
        r = self.recipe
        for p in self.params.values():
            p.grad = None
        loss = self.loss(ids, mask, run_seed, step)
        loss.backward()
        names = list(self.params)
        grads = [self.params[n].grad for n in names]
        if not self.first_grads:
            self.first_grads = {n: g.detach().clone() for n, g in zip(names, grads)}
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
        if norm >= r["max_grad_norm"]:
            grads = [g * (r["max_grad_norm"] / norm) for g in grads]
        lr = warmuplinear(r["learning_rate"], r["warmup_steps"], self.total, self.count)
        self.count += 1
        bc1 = 1 - 0.9 ** self.count
        bc2 = 1 - 0.999 ** self.count
        with torch.no_grad():
            for n, g in zip(names, grads):
                p = self.params[n]
                self.mu[n].mul_(0.9).add_(g, alpha=0.1)
                self.nu[n].mul_(0.999).addcmul_(g, g, value=0.001)
                upd = (self.mu[n] / bc1) / (torch.sqrt(self.nu[n] / bc2) + 1e-8)
                upd = upd + r["weight_decay"] * p
                p.sub_(lr * upd)
        return float(loss.detach())


def run_steps(cfg: Mapping, recipe: Mapping, sd: Mapping[str, torch.Tensor], total_steps: int,
              batches: Sequence, run_seed: int, precision: str = "f32",
              half_batch: bool = False, start=None) -> "Trainer":
    """``batches``: (ids, mask, step) per step, in order → the trainer after
    them, with ``losses`` set."""
    tr = Trainer(cfg, recipe, sd, total_steps, precision, half_batch, start)
    tr.losses: List[float] = [tr.step(ids, mask, run_seed, step) for ids, mask, step in batches]
    return tr
