"""Validation-loss evaluator — counterpart of
``qst_tpu/evals/loss_evaluator.py``.

Capability match for the reference ``QuadrupletLossEvaluator``
(models/evaluators.py:34-127): iterate the validation set without gradients
or dropout, compute the running-average quadruplet loss, and append
``{epoch, steps, average_loss}`` to a cumulative JSON log. The loss is
``train/train_step.py``'s ``make_eval_loss_fn``: through K1 and K3 on a GPU
when the configs ask for the fused layer and loss.
"""

from __future__ import annotations

import os
from typing import Any, Iterable, Optional

from qst_tpu_torch.core.config import EncoderConfig, LossConfig
from qst_tpu_torch.core.telemetry import JsonLogSink
from qst_tpu_torch.data.collate import QuadrupletCollator
from qst_tpu_torch.train.train_step import make_eval_loss_fn

LOG_SUFFIX = "_quadruplet_loss_eval.json"


class QuadrupletLossEvaluator:
    """Returns the NEGATED average loss so that "higher is better" composes
    with max-mode early stopping/best-model tracking; the raw loss is logged.
    (The reference returns raw loss and runs its callback in min mode.)

    Called with the model (an ``nn.Module``: ``SentenceEncoderModule``)
    where the JAX evaluator takes params."""

    def __init__(
        self,
        encoder_cfg: EncoderConfig,
        loss_cfg: LossConfig,
        batches: Iterable,          # reusable iterable of instance lists
        collator: QuadrupletCollator,
        log_dir: Optional[str] = None,
        name: str = "val",
        negate: bool = True,
    ):
        self.batches = batches
        self.collator = collator
        self._loss_fn = make_eval_loss_fn(encoder_cfg, loss_cfg)
        self.negate = negate
        self._sink = (
            JsonLogSink(os.path.join(log_dir, name + LOG_SUFFIX))
            if log_dir else None
        )

    def __call__(self, model: Any, epoch: int = -1, steps: int = -1,
                 discriminator: Any = None) -> float:
        total, count = 0.0, 0
        for batch in self.batches:
            qb = self.collator(batch)
            loss = self._loss_fn(model, qb.input_ids, qb.attention_mask, discriminator)
            total += float(loss)
            count += 1
        avg = total / max(count, 1)
        if self._sink is not None:
            self._sink.append({"epoch": epoch, "steps": steps,
                               "average_loss": avg})
        return -avg if self.negate else avg
