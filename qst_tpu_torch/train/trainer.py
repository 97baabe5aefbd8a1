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

The state and the step are chosen as the JAX trainer chooses them
(``trainer.py:120-170``): ``pp_stages`` > 1 trains the pipelined trunk on a
("pipe", "data") mesh (``parallel/pipeline.py``); a mesh with a model axis
> 1 the tensor-parallel state (``create_train_state_sharded``); otherwise
the plain state; a mesh's data axis runs the step data-parallel. The
evaluator and the best artifact get the flat model (``flat_model``).
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
from qst_tpu_torch.core.meshes import MODEL_AXIS, PIPE_AXIS, as_mesh
from qst_tpu_torch.core.telemetry import JsonLogSink, StepTimer
from qst_tpu_torch.data.collate import QuadrupletCollator
from qst_tpu_torch.data.prefetch import PrefetchIterator
from qst_tpu_torch.data.quadruplet_dataset import QuadrupletDataset
from qst_tpu_torch.train.callbacks import EarlyStopping
from qst_tpu_torch.train.checkpoints import CheckpointManager
from qst_tpu_torch.train.train_step import (
    TrainState,
    create_train_state,
    create_train_state_sharded,
    dropout_key,
    make_optimizer,
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
    score drives early stopping and best-model saving; it gets the flat
    model whatever the layout. ``device``: where the model trains (default:
    the GPU; with a mesh, the mesh's first device).

    ``mesh``: a ``core/meshes.py`` mesh — its data axis shards each batch,
    a model axis > 1 takes the tensor-parallel state. ``pp_stages`` > 1
    trains through the pipelined trunk: ``mesh`` must then be a ("pipe",
    "data") mesh from ``make_pipe_mesh``; ``pp_microbatches`` defaults to
    ``pp_stages``; ``pp_rounds`` > 1 selects the circular schedule.
    Checkpoints store the stacked stage layout (resume with the same
    flags); the best artifact is saved in the flat layout."""

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
        if pp_stages > 1 and loss_cfg.kind == "d_regularized":
            raise ValueError(
                "d_regularized loss is not supported with pipeline "
                "training")
        self.encoder_cfg = encoder_cfg
        self.loss_cfg = loss_cfg
        self.train_cfg = train_cfg
        self.dataset = dataset
        self.collator = collator
        self.evaluator = evaluator
        self.mesh = as_mesh(mesh)
        self.steps_per_call = steps_per_call
        self.initial_params = initial_params
        self.pp_stages = pp_stages
        self.pp_microbatches = pp_microbatches or pp_stages
        self.pp_rounds = pp_rounds
        self.device = self.mesh.devices[0] if self.mesh is not None else resolve_device(device)
        self.steps_per_epoch = steps_per_epoch or max(
            1, len(dataset) // train_cfg.batch_size)
        self.total_steps = self.steps_per_epoch * train_cfg.epochs
        self.timer = StepTimer()

    def flat_model(self, state: TrainState) -> torch.nn.Module:
        """The state's model as a plain ``SentenceEncoderModule`` on the
        trainer's device: itself, or for a tensor-parallel or pipeline state
        a copy with the slices gathered and the stages unstacked
        (``flat_params``, ``qst_tpu/train/trainer.py:188``)."""
        if state.layout is None:
            return state.model
        from qst_tpu_torch.models.sentence_encoder import SentenceEncoderModule

        with torch.device("meta"):
            model = SentenceEncoderModule(self.encoder_cfg)
        model = model.to_empty(device=self.device)
        model.load_state_dict(state.flat_state_dict())
        return model

    def train(self, seed: Optional[int] = None, resume: bool = False) -> TrainResult:
        cfg = self.train_cfg
        seed = cfg.seed if seed is None else seed
        gen = torch.Generator().manual_seed(seed)
        mesh = self.mesh
        if self.pp_stages > 1:
            from qst_tpu_torch.models.sentence_encoder import init_params
            from qst_tpu_torch.parallel.pipeline import (
                PipelineLayout,
                make_pp_train_step,
                pp_params_from_encoder,
            )

            if mesh is None or PIPE_AXIS not in mesh.shape:
                raise ValueError(
                    "pipeline training needs a ('pipe', 'data') mesh "
                    "(qst_tpu_torch.parallel.pipeline.make_pipe_mesh)")
            full = (self.initial_params if self.initial_params is not None
                    else init_params(self.encoder_cfg, gen, device=self.device))
            model = pp_params_from_encoder(full, self.encoder_cfg, self.pp_stages, mesh,
                                           self.pp_rounds)
            optimizer = make_optimizer(cfg, self.total_steps, model.parameters())
            state = TrainState(step=0, model=model, optimizer=optimizer,
                               layout=PipelineLayout(self.encoder_cfg, self.pp_stages,
                                                     self.pp_rounds))
            step_fn = make_pp_train_step(self.encoder_cfg, self.loss_cfg, None, mesh,
                                         self.pp_stages, self.pp_microbatches, self.pp_rounds)
        elif mesh is not None and mesh.shape.get(MODEL_AXIS, 1) > 1:
            state, _ = create_train_state_sharded(
                self.encoder_cfg, cfg, gen, self.total_steps, mesh, self.loss_cfg,
                initial_params=self.initial_params)
        else:
            state, _ = create_train_state(
                self.encoder_cfg, cfg, gen, self.total_steps, self.loss_cfg,
                initial_params=self.initial_params, device=self.device)
        if self.pp_stages == 1:
            step_fn = make_train_step(self.encoder_cfg, self.loss_cfg, None, mesh)

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
            flat = self.flat_model(state)
            score = float(self.evaluator(flat, epoch, steps))
            history.append({"epoch": epoch, "steps": steps, "score": score})
            # the best artifact stores the flat layout whatever the
            # parallelism (a pipeline's best state too, as the JAX trainer's)
            ckpt.update_best(state if self.pp_stages == 1 else TrainState(
                step=state.step, model=flat, optimizer=state.optimizer), score)
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
        multi_fn = (make_multi_step(self.encoder_cfg, self.loss_cfg, state.optimizer, K, mesh)
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
