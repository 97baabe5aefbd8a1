"""Training callbacks — a host copy of ``qst_tpu/train/callbacks.py``
(``tests/test_torch_train.py`` holds it to its source).

The reference stops early by raising a ``BaseException`` through the library
``fit()`` loop (reference training/callbacks.py:47-87, caught at
training/main.py:149-150). Here early stopping is a plain loop condition —
``EarlyStopping.update`` returns ``should_stop`` — same min/max mode,
patience, and delta semantics, no exception control flow.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass, field

logger = logging.getLogger("qst_tpu_torch.callbacks")


class Callback:
    """Score-observer invoked after each evaluation (score, epoch, steps)."""

    def __call__(self, score: float, epoch: int, steps: int) -> None:
        self.on_evaluation(score, epoch, steps)

    def on_evaluation(self, score: float, epoch: int, steps: int) -> None:
        raise NotImplementedError


@dataclass
class EarlyStopping(Callback):
    patience: int = 5
    delta: float = 0.0
    mode: str = "max"  # "max": higher is better; "min": lower is better
    best_score: float = field(init=False)
    best_epoch: int = field(init=False, default=-1)
    best_steps: int = field(init=False, default=-1)
    counter: int = field(init=False, default=0)
    stopped: bool = field(init=False, default=False)

    def __post_init__(self):
        if self.mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', {self.mode} given")
        if self.patience < 1:
            raise ValueError(f"patience must be >= 1, {self.patience} given")
        self.best_score = -math.inf if self.mode == "max" else math.inf

    def _improved(self, score: float) -> bool:
        if self.mode == "max":
            return score > self.best_score + self.delta
        return score < self.best_score - self.delta

    def update(self, score: float, epoch: int, steps: int) -> bool:
        """Record a score; → True when training should stop."""
        if self._improved(score):
            self.best_score = score
            self.best_epoch = epoch
            self.best_steps = steps
            self.counter = 0
        else:
            self.counter += 1
            if self.counter >= self.patience:
                self.stopped = True
                logger.info(
                    "early stopping: best score %.6f at epoch %d step %d",
                    self.best_score, self.best_epoch, self.best_steps)
        return self.stopped

    def on_evaluation(self, score: float, epoch: int, steps: int) -> None:
        self.update(score, epoch, steps)
