"""Pooling ops — counterpart of ``qst_tpu/ops/pooling.py``."""

from __future__ import annotations

import torch


def mean_pool(hidden: torch.Tensor,
              attention_mask: torch.Tensor) -> torch.Tensor:
    """Masked mean over the sequence axis.

    hidden: (B, S, D); attention_mask: (B, S) in {0,1} → (B, D) float32.
    Matches sentence-transformers' mean pooling: sum(h*m)/clamp(sum(m), 1e-9).
    """
    mask = attention_mask[..., None].float()
    summed = torch.sum(hidden.float() * mask, dim=1)
    counts = torch.clamp(torch.sum(mask, dim=1), min=1e-9)
    return summed / counts


def cls_pool(hidden: torch.Tensor,
             attention_mask: torch.Tensor) -> torch.Tensor:
    return hidden[:, 0, :].float()


def max_pool(hidden: torch.Tensor,
             attention_mask: torch.Tensor) -> torch.Tensor:
    mask = attention_mask[..., None].bool()
    h = torch.where(mask, hidden.float(),
                    torch.tensor(float("-inf"), device=hidden.device))
    return torch.max(h, dim=1).values


POOLERS = {"mean": mean_pool, "cls": cls_pool, "max": max_pool}
