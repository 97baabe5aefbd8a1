"""Evaluators (counterpart of ``qst_tpu/evals``)."""

from qst_tpu_torch.evals.ir_metrics import (
    ir_metrics,
    triplet_accuracy,
    quadruplet_global_accuracy,
)
from qst_tpu_torch.evals.ir_evaluator import InformationRetrievalEvaluator
from qst_tpu_torch.evals.loss_evaluator import QuadrupletLossEvaluator
from qst_tpu_torch.evals.quadruplet_evaluator import QuadrupletEvaluator
from qst_tpu_torch.evals.sequential import SequentialEvaluator
from qst_tpu_torch.evals.eval_set import IREvaluationSet, create_ir_evaluation_set
from qst_tpu_torch.evals.factory import get_sequential_evaluator

__all__ = [
    "ir_metrics",
    "triplet_accuracy",
    "quadruplet_global_accuracy",
    "InformationRetrievalEvaluator",
    "QuadrupletLossEvaluator",
    "QuadrupletEvaluator",
    "SequentialEvaluator",
    "IREvaluationSet",
    "create_ir_evaluation_set",
    "get_sequential_evaluator",
]
