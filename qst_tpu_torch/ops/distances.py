"""Distance / similarity ops — counterpart of ``qst_tpu/ops/distances.py``.

- ``cos_sim`` / ``dot_score``: the sentence-transformers score functions.
- ``euclid_score``: ``1 / (1 + cdist(a, b, p=2))``.

Every input is upcast to float32 before its product, as the JAX versions
accumulate in float32: a bf16 or int8 input then gives exact products with
float32 sums, where torch's own bf16 product would round its output to bf16.
"""

from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, eps: float = 1e-12,
                 axis: int = -1) -> torch.Tensor:
    """Torch-style F.normalize: x / max(||x||_2, eps)."""
    norm = torch.linalg.vector_norm(x, dim=axis, keepdim=True)
    return x / torch.clamp(norm, min=eps)


def cos_sim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full pairwise cosine-similarity matrix, shape (A, B)."""
    a = l2_normalize(a.float())
    b = l2_normalize(b.float())
    return a @ b.T


def dot_score(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full pairwise dot-product matrix, shape (A, B)."""
    return a.float() @ b.float().T


def cdist2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise Euclidean distance matrix via the expanded-square identity
    (one product plus rank-1 corrections, O(A*B) memory)."""
    a = a.float()
    b = b.float()
    aa = torch.sum(a * a, dim=-1)[:, None]
    bb = torch.sum(b * b, dim=-1)[None, :]
    sq = torch.clamp(aa + bb - 2.0 * (a @ b.T), min=0.0)
    return torch.sqrt(sq)


def euclid_score(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Similarity-from-distance: 1/(1+cdist)."""
    return 1.0 / (1.0 + cdist2(a, b))


SCORE_FUNCTIONS = {
    "cos_sim": cos_sim,
    "dot_score": dot_score,
    "euclid_score": euclid_score,
}
