"""Tensor ops and kernel wrappers (counterpart of ``qst_tpu/ops``)."""

from qst_tpu_torch.ops.distances import (
    pairwise_distance,
    l2_normalize,
    cos_sim,
    dot_score,
    cdist2,
    euclid_score,
    SCORE_FUNCTIONS,
)
from qst_tpu_torch.ops.losses import (
    triplet_margin_loss,
    gamma_quadruplet_loss,
    d_regularized_quadruplet_loss,
    GammaQuadrupletLoss,
    DRegularizedQuadrupletLoss,
    bce_with_logits,
)
from qst_tpu_torch.ops.pooling import mean_pool, cls_pool, max_pool, POOLERS

__all__ = [
    "pairwise_distance",
    "l2_normalize",
    "cos_sim",
    "dot_score",
    "cdist2",
    "euclid_score",
    "SCORE_FUNCTIONS",
    "triplet_margin_loss",
    "gamma_quadruplet_loss",
    "d_regularized_quadruplet_loss",
    "GammaQuadrupletLoss",
    "DRegularizedQuadrupletLoss",
    "bce_with_logits",
    "mean_pool",
    "cls_pool",
    "max_pool",
    "POOLERS",
]
