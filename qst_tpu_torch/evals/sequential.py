"""Sequential evaluator composition — a host copy of
``qst_tpu/evals/sequential.py``.

Capability match for sentence-transformers' ``SequentialEvaluator`` as used
by the reference factory ``get_sequential_evaluator``
(models/evaluators.py:532-614): run evaluators in order; the MAIN score is
the last evaluator's score (the reference deliberately orders the loss
evaluator last, evaluators.py:602).
"""

from __future__ import annotations

from typing import Callable, List, Sequence


class SequentialEvaluator:
    def __init__(self, evaluators: Sequence[Callable],
                 main_score_function: Callable[[List[float]], float] = None):
        if not evaluators:
            raise ValueError("need at least one evaluator")
        self.evaluators = list(evaluators)
        self.main_score_function = main_score_function or (lambda s: s[-1])
        self.last_scores: List[float] = []

    def __call__(self, *args, **kwargs) -> float:
        self.last_scores = [ev(*args, **kwargs) for ev in self.evaluators]
        return float(self.main_score_function(self.last_scores))
