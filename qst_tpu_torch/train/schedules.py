"""Learning-rate schedules — counterpart of ``qst_tpu/train/schedules.py``.

The five scheduler choices of the reference's ``SentenceTransformer.fit``
(constantlr, warmupconstant, warmuplinear, warmupcosine,
warmupcosinewithhardrestarts), each a function of the optimizer step count
with optax's semantics: ``linear_schedule`` clips its count to the
transition, ``join_schedules`` hands step − boundary to the next piece, and
the optimizer evaluates the schedule at the count before its update (step
0 first).
"""

from __future__ import annotations

import math
from typing import Callable, Dict

Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule (polynomial, power 1)."""
    if steps <= 0:
        return lambda count: init

    def schedule(count: int) -> float:
        c = min(max(count, 0), steps)
        return (init - end) * (1 - c / steps) + end

    return schedule


def _join(first: Schedule, second: Schedule, boundary: int) -> Schedule:
    """optax.join_schedules with one boundary."""
    return lambda count: first(count) if count < boundary else second(count - boundary)


def constantlr(lr: float, warmup_steps: int, total_steps: int) -> Schedule:
    return lambda count: lr


def warmupconstant(lr: float, warmup_steps: int, total_steps: int) -> Schedule:
    warmup = max(1, warmup_steps)
    return _join(_linear(0.0, lr, warmup), lambda count: lr, warmup)


def warmuplinear(lr: float, warmup_steps: int, total_steps: int) -> Schedule:
    warmup = max(1, min(warmup_steps, max(total_steps - 1, 1)))
    decay = max(1, total_steps - warmup)
    return _join(_linear(0.0, lr, warmup), _linear(lr, 0.0, decay), warmup)


def warmupcosine(lr: float, warmup_steps: int, total_steps: int) -> Schedule:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, decay_steps, 0)."""
    warmup = max(1, min(warmup_steps, max(total_steps - 1, 1)))
    decay_steps = max(total_steps, warmup + 1) - warmup

    def cosine(count: int) -> float:
        c = min(count, decay_steps)
        return lr * (0.5 * (1 + math.cos(math.pi * c / decay_steps)))

    return _join(_linear(0.0, lr, warmup), cosine, warmup)


def warmupcosinewithhardrestarts(lr: float, warmup_steps: int, total_steps: int,
                                 num_cycles: int = 3) -> Schedule:
    warmup = max(1, min(warmup_steps, max(total_steps - 1, 1)))
    decay = max(1, total_steps - warmup)

    def after_warmup(count: int) -> float:
        progress = min(max(count / decay, 0.0), 1.0)
        cycle_progress = (progress * num_cycles) % 1.0
        return lr * max(0.0, 0.5 * (1.0 + math.cos(math.pi * cycle_progress)))

    return _join(_linear(0.0, lr, warmup), after_warmup, warmup)


SCHEDULES: Dict[str, Callable[..., Schedule]] = {
    "constantlr": constantlr,
    "warmupconstant": warmupconstant,
    "warmuplinear": warmuplinear,
    "warmupcosine": warmupcosine,
    "warmupcosinewithhardrestarts": warmupcosinewithhardrestarts,
}


def get_schedule(name: str, lr: float, warmup_steps: int, total_steps: int) -> Schedule:
    if name not in SCHEDULES:
        raise ValueError(
            f"unknown scheduler {name!r}; choices: {sorted(SCHEDULES)}")
    return SCHEDULES[name](lr, warmup_steps, total_steps)
