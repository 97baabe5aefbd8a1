"""The training loop — counterpart of ``qst_tpu/train/trainer.py``.

Per-epoch iteration over fixed-shape quadruplet batches (sampled and
collated on a prefetch thread), one train step per batch, periodic
evaluation driving early stopping and best-model checkpoints, a
pre-training evaluation at epoch −1, periodic checkpoints and a resume that
fast-forwards the already-trained batches. Every per-step draw is a pure
function of (seed, step): the dataset's sampling and the dropout key
(seed, global_step + 1), as ``jax.random.fold_in`` is at ``trainer.py:272``,
so a resumed run continues the interrupted one.

``steps_per_call`` K > 1 hands K collated batches at a time to
``make_multi_step`` — one CUDA graph replay on the GPU — as the JAX trainer
hands them to its scanned step (``trainer.py:236-280``); a remainder of
fewer than K batches runs single steps.

Not ported: pipeline parallelism (``pp_*``) and the ``mesh`` raise
``NotImplementedError``.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from qst_tpu_torch.core.config import EncoderConfig, LossConfig, TrainConfig, save_config
from qst_tpu_torch.core.device import resolve_device
from qst_tpu_torch.core.telemetry import JsonLogSink, StepTimer
from qst_tpu_torch.data.collate import QuadrupletCollator
from qst_tpu_torch.data.prefetch import PrefetchIterator
from qst_tpu_torch.data.quadruplet_dataset import QuadrupletDataset
from qst_tpu_torch.train.callbacks import EarlyStopping
from qst_tpu_torch.train.checkpoints import CheckpointManager
from qst_tpu_torch.train.train_step import (
    TrainState,
    create_train_state,
    dropout_key,
    make_multi_step,
    make_train_step,
)

logger = logging.getLogger("qst_tpu_torch.trainer")


@dataclass
class TrainResult:
    state: TrainState
    best_score: float
    best_epoch: int
    history: List[Dict[str, float]]
    stopped_early: bool
    steps_per_sec: float


class Trainer:
    """Quadruplet fine-tuning loop.

    evaluator: optional callable ``(model, epoch, steps) -> float`` whose
    score drives early stopping and best-model saving. ``device``: where the
    model trains (default: the GPU)."""

    def __init__(
        self,
        encoder_cfg: EncoderConfig,
        loss_cfg: LossConfig,
        train_cfg: TrainConfig,
        dataset: QuadrupletDataset,
        collator: QuadrupletCollator,
        evaluator: Optional[Callable[[Any, int, int], float]] = None,
        mesh=None,
        steps_per_epoch: Optional[int] = None,
        steps_per_call: int = 1,
        initial_params: Optional[Dict[str, torch.Tensor]] = None,
        pp_stages: int = 1,
        pp_microbatches: int = 0,
        pp_rounds: int = 1,
        device: Any = None,
    ):
        """``initial_params``: start from this state dict (an imported
        checkpoint) instead of random weights; ``resume`` restores over it."""
        if steps_per_call < 1:
            raise ValueError(f"steps_per_call must be >= 1, {steps_per_call}")
        if pp_stages > 1 and steps_per_call > 1:
            raise ValueError(
                "steps_per_call > 1 is not supported with pipeline "
                "training (the PP schedule is already a scanned multi-tick "
                "dispatch)")
        if mesh is not None or pp_stages > 1 or pp_microbatches or pp_rounds != 1:
            raise NotImplementedError("mesh and pipeline training are not ported yet")
        self.encoder_cfg = encoder_cfg
        self.loss_cfg = loss_cfg
        self.train_cfg = train_cfg
        self.dataset = dataset
        self.collator = collator
        self.evaluator = evaluator
        self.mesh = mesh
        self.steps_per_call = steps_per_call
        self.initial_params = initial_params
        self.pp_stages = pp_stages
        self.pp_microbatches = pp_microbatches or pp_stages
        self.pp_rounds = pp_rounds
        self.device = resolve_device(device)
        self.steps_per_epoch = steps_per_epoch or max(
            1, len(dataset) // train_cfg.batch_size)
        self.total_steps = self.steps_per_epoch * train_cfg.epochs
        self.timer = StepTimer()

    def train(self, seed: Optional[int] = None, resume: bool = False) -> TrainResult:
        cfg = self.train_cfg
        seed = cfg.seed if seed is None else seed
        state, _ = create_train_state(
            self.encoder_cfg, cfg, torch.Generator().manual_seed(seed), self.total_steps,
            self.loss_cfg, initial_params=self.initial_params, device=self.device)
        step_fn = make_train_step(self.encoder_cfg, self.loss_cfg)

        os.makedirs(cfg.experiment_dir, exist_ok=True)
        save_config(
            {"encoder": self.encoder_cfg, "loss": self.loss_cfg, "train": cfg},
            os.path.join(cfg.experiment_dir, "experiment_config.json"))
        loss_log = JsonLogSink(os.path.join(cfg.experiment_dir, "train_loss.json"))

        ckpt = CheckpointManager(
            os.path.join(cfg.experiment_dir, "checkpoints"),
            save_steps=cfg.checkpoint_save_steps,
            total_limit=cfg.checkpoint_save_total_limit,
            save_best=cfg.save_best_model,
            mode=cfg.early_stopping_mode)
        if resume and ckpt.restore_latest(state) is not None:
            logger.info("resumed from step %d", state.step)

        stopper = EarlyStopping(
            patience=cfg.early_stopping_patience,
            delta=cfg.early_stopping_delta,
            mode=cfg.early_stopping_mode)
        history: List[Dict[str, float]] = []

        def run_eval(epoch: int, steps: int) -> Optional[float]:
            if self.evaluator is None:
                return None
            score = float(self.evaluator(state.model, epoch, steps))
            history.append({"epoch": epoch, "steps": steps, "score": score})
            ckpt.update_best(state, score)
            return score

        # pre-training evaluation (reference training/main.py:126)
        run_eval(epoch=-1, steps=-1)

        global_step = state.step
        # resume fast-forward: the per-epoch batch order and the per-step
        # draws are functions of (epoch, step), so skipping the trained
        # batches continues the interrupted run
        steps_per_epoch = max(1, len(self.dataset) // cfg.batch_size)
        start_epoch, resume_skip = divmod(global_step, steps_per_epoch)
        if global_step == 0:
            start_epoch, resume_skip = 0, 0
        stop = False
        t_start = time.perf_counter()
        steps_run = 0
        loss = None
        K = self.steps_per_call
        multi_fn = (make_multi_step(self.encoder_cfg, self.loss_cfg, state.optimizer, K)
                    if K > 1 else None)
        for epoch in range(start_epoch, cfg.epochs):
            if stop:
                break
            skip = resume_skip if epoch == start_epoch else 0
            # sampling + collation run on a host thread, hidden behind the step
            prefetch = PrefetchIterator(
                self.dataset.iter_batches(cfg.batch_size, shuffle=True, epoch=epoch,
                                          step_offset=global_step, start_batch=skip),
                transform=self.collator, depth=2 * K)
            pending = []
            iterator = iter(prefetch)
            exhausted = False
            while not exhausted and not stop:
                # collect up to steps_per_call collated batches
                while len(pending) < K:
                    try:
                        pending.append(next(iterator))
                    except StopIteration:
                        exhausted = True
                        break
                if not pending:
                    break
                step_before = global_step
                if multi_fn is not None and len(pending) == K:
                    keys = torch.stack([dropout_key(seed, global_step + 1 + j)
                                        for j in range(K)])
                    with self.timer.phase("train_step"):
                        state, losses = multi_fn(
                            state, np.stack([b.input_ids for b in pending]),
                            np.stack([b.attention_mask for b in pending]), keys)
                    loss = losses[-1]
                    global_step += K
                    steps_run += K
                else:  # remainder (or steps_per_call == 1): single steps
                    for qb in pending:
                        with self.timer.phase("train_step"):
                            state, loss = step_fn(state, qb.input_ids, qb.attention_mask,
                                                  dropout_key(seed, global_step + 1))
                        global_step += 1
                        steps_run += 1
                pending = []
                ev = cfg.evaluation_steps
                if ev > 0 and (step_before // ev) != (global_step // ev):
                    loss_log.append({"epoch": epoch, "steps": global_step,
                                     "loss": float(loss)})
                    score = run_eval(epoch, global_step)
                    if score is not None and stopper.update(score, epoch, global_step):
                        stop = True
                        prefetch.close()
                        break
                cs = cfg.checkpoint_save_steps
                if cs > 0 and (step_before // cs) != (global_step // cs):
                    ckpt.save_now(state, global_step)
            if not stop:
                score = run_eval(epoch, global_step)
                if score is not None and stopper.update(score, epoch, global_step):
                    stop = True

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t_start
        ckpt.save_now(state, global_step)
        ckpt.close()
        return TrainResult(
            state=state,
            best_score=stopper.best_score,
            best_epoch=stopper.best_epoch,
            history=history,
            stopped_early=stopper.stopped,
            steps_per_sec=steps_run / elapsed if elapsed > 0 else 0.0,
        )
