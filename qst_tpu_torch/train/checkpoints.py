"""Checkpoints: periodic + best-model, with total-limit retention —
counterpart of ``qst_tpu/train/checkpoints.py`` on ``torch.save`` in place
of Orbax.

The directory roles are the source's: ``<dir>/periodic/<step>/`` keeps the
``total_limit`` newest full states (model, optimizer, step, discriminator)
for resume; ``<dir>/best/state.pt`` and the params-only
``<dir>/best/params.pt`` (the model's state dict, loadable without an
optimizer) follow the best evaluation score. Every file is written to a
temporary name and renamed, so a crash mid-save leaves the last good one.

A tensor-parallel state is saved gathered, under HF names, and a pipeline
state in its stacked stage layout (``TrainState.layout``; moments
alike); ``restore_latest`` lays them back out into the template's layout,
as Orbax restores into the template's sharding. ``params.pt`` always holds
the flat layout, which ``ir_eval_main`` and ``index_main`` load unchanged.

A manager knows nothing of a group of processes: the ``Trainer`` saves
through process 0's only, and every process reads on resume, so processes
on more than one host need a checkpoint directory on a filesystem they
share.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, List, Optional

import torch

from qst_tpu_torch.train.train_step import TrainState

_STATE = "state.pt"


def _save(obj: Any, path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _load(path: str) -> Any:
    return torch.load(path, map_location="cpu", weights_only=True)


class CheckpointManager:
    def __init__(self, directory: str, save_steps: int = 500,
                 total_limit: int = 2, save_best: bool = True,
                 mode: str = "max"):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be min/max, {mode} given")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.save_steps = save_steps
        self.total_limit = total_limit
        self.save_best = save_best
        self.mode = mode
        self._best_score: Optional[float] = None
        self._periodic = os.path.join(self.directory, "periodic")
        self._best_dir = os.path.join(self.directory, "best")
        os.makedirs(self._periodic, exist_ok=True)

    def steps(self) -> List[int]:
        """The periodic checkpoints on disk, oldest first."""
        return sorted(int(e) for e in os.listdir(self._periodic)
                      if e.isdigit() and os.path.isfile(os.path.join(self._periodic, e, _STATE)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def _save_periodic(self, state: TrainState, step: int) -> None:
        _save(state.state_dict(), os.path.join(self._periodic, str(step), _STATE))
        steps = self.steps()
        for old in steps[:max(0, len(steps) - self.total_limit)]:
            shutil.rmtree(os.path.join(self._periodic, str(old)), ignore_errors=True)

    def maybe_save(self, state: TrainState, step: int) -> bool:
        if self.save_steps > 0 and step > 0 and step % self.save_steps == 0:
            self._save_periodic(state, step)
            return True
        return False

    def save_now(self, state: TrainState, step: int) -> None:
        if self.latest_step() == step:  # periodic save already hit it
            return
        self._save_periodic(state, step)

    def update_best(self, state: TrainState, score: float) -> bool:
        """Save under best/ if score improves (reference save_best_model)."""
        if not self.save_best:
            return False
        improved = (
            self._best_score is None
            or (self.mode == "max" and score > self._best_score)
            or (self.mode == "min" and score < self._best_score)
        )
        if improved:
            self._best_score = score
            _save(state.state_dict(), os.path.join(self._best_dir, _STATE))
            _save(state.flat_state_dict(), os.path.join(self._best_dir, "params.pt"))
        return improved

    def restore_latest(self, template: TrainState) -> Optional[TrainState]:
        """Load the newest periodic checkpoint into ``template`` (model and
        optimizer in place) and return it, or None when there is none."""
        step = self.latest_step()
        if step is None:
            return None
        template.load_state_dict(_load(os.path.join(self._periodic, str(step), _STATE)))
        return template

    def restore_best(self, template: TrainState) -> Optional[TrainState]:
        path = os.path.join(self._best_dir, _STATE)
        if not os.path.isfile(path):
            return None
        template.load_state_dict(_load(path))
        return template

    def restore_best_params(self) -> Optional[Dict[str, torch.Tensor]]:
        """→ the best model's state dict (no template needed), or None."""
        path = os.path.join(self._best_dir, "params.pt")
        return _load(path) if os.path.isfile(path) else None

    def close(self) -> None:
        """Saves are synchronous; nothing is left to wait for."""
