"""Training (counterpart of ``qst_tpu/train``): schedules, the train step
with its optimizer, callbacks, checkpoints and the ``Trainer``."""

from qst_tpu_torch.train.callbacks import EarlyStopping
from qst_tpu_torch.train.checkpoints import CheckpointManager
from qst_tpu_torch.train.schedules import get_schedule
from qst_tpu_torch.train.train_step import (
    ClippedAdamW,
    TrainState,
    create_train_state,
    encoder_apply_fn,
    loss_from_config,
    make_eval_loss_fn,
    make_optimizer,
    make_train_step,
)
from qst_tpu_torch.train.trainer import Trainer, TrainResult

__all__ = ["CheckpointManager", "ClippedAdamW", "EarlyStopping", "TrainResult", "TrainState",
           "Trainer", "create_train_state", "encoder_apply_fn", "get_schedule",
           "loss_from_config", "make_eval_loss_fn", "make_optimizer", "make_train_step"]
