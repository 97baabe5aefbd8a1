"""Evaluator factory — counterpart of ``qst_tpu/evals/factory.py``.

Capability match for the reference ``get_sequential_evaluator``
(models/evaluators.py:532-614): assemble a SequentialEvaluator over
[InformationRetrievalEvaluator?, QuadrupletEvaluator, QuadrupletLossEvaluator]
with the loss LAST (its score is the main score, reference :602) — adapted to
the port's ``Trainer``, which hands over its ``nn.Module``:
``evaluator(model, epoch, steps) -> float``.

Each call copies the model's weights into a fresh ``SentenceEncoder`` (as
the JAX factory builds one from the params), in eval mode and without
gradients, and every evaluator runs on that copy: evaluation leaves the
training module's mode, parameters and autograd state, and every generator,
as they were.

The reference's relevant-set bug at :561 does not apply: the eval set
already maps each query to its own doc-id set (qst_tpu_torch.evals.eval_set).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

from qst_tpu_torch.core.config import EncoderConfig, IREvalConfig, LossConfig
from qst_tpu_torch.data.collate import QuadrupletCollator
from qst_tpu_torch.evals.eval_set import IREvaluationSet
from qst_tpu_torch.evals.ir_evaluator import InformationRetrievalEvaluator
from qst_tpu_torch.evals.loss_evaluator import QuadrupletLossEvaluator
from qst_tpu_torch.evals.quadruplet_evaluator import QuadrupletEvaluator
from qst_tpu_torch.models.sentence_encoder import SentenceEncoder


def get_sequential_evaluator(
    encoder_cfg: EncoderConfig,
    loss_cfg: LossConfig,
    tokenizer: Any,
    val_instances: Sequence[dict],
    val_batches: Optional[Sequence] = None,
    collator: Optional[QuadrupletCollator] = None,
    ir_eval_set: Optional[IREvaluationSet] = None,
    ir_cfg: Optional[IREvalConfig] = None,
    log_dir: Optional[str] = None,
    mesh=None,
    main: str = "loss",  # "loss" (reference ordering) | "ir" | "quadruplet"
) -> Callable[[Any, int, int], float]:
    """→ ``evaluator(model, epoch, steps) -> float`` for the Trainer."""
    collator = collator or QuadrupletCollator(
        tokenizer, max_length=encoder_cfg.max_seq_length)

    evaluators: List[tuple] = []  # (kind, evaluator)
    if ir_eval_set is not None:
        evaluators.append((
            "ir",
            InformationRetrievalEvaluator(
                ir_eval_set.queries, ir_eval_set.corpus, ir_eval_set.relevant,
                cfg=ir_cfg, mesh=mesh, log_dir=log_dir),
        ))
    if val_instances:
        evaluators.append((
            "quadruplet",
            QuadrupletEvaluator.from_instances(
                list(val_instances), gamma=loss_cfg.gamma, log_dir=log_dir),
        ))
    if val_batches is not None:
        evaluators.append((
            "loss",
            QuadrupletLossEvaluator(
                encoder_cfg, loss_cfg, val_batches, collator, log_dir=log_dir),
        ))
    if not evaluators:
        raise ValueError("no evaluators configured")

    # main-score evaluator goes last (SequentialEvaluator takes the last score)
    evaluators.sort(key=lambda kv: kv[0] == main)

    def evaluator(model: Any, epoch: int, steps: int) -> float:
        encoder = SentenceEncoder(encoder_cfg, model.state_dict(), tokenizer)
        scores = []
        for kind, ev in evaluators:
            if kind == "loss":
                scores.append(ev(encoder.model, epoch, steps))
            else:
                scores.append(ev(encoder.encode, epoch, steps))
        return float(scores[-1])

    evaluator.evaluators = evaluators  # type: ignore[attr-defined]
    return evaluator
