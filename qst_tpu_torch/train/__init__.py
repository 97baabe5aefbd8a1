"""Training (counterpart of ``qst_tpu/train``): schedules, the train step
with its optimizer, callbacks, checkpoints and the ``Trainer``."""

from qst_tpu_torch.train.callbacks import Callback, EarlyStopping
from qst_tpu_torch.train.checkpoints import CheckpointManager
from qst_tpu_torch.train.schedules import SCHEDULES, get_schedule
from qst_tpu_torch.train.train_step import (
    ClippedAdamW,
    TrainState,
    create_train_state,
    dropout_key,
    encoder_apply_fn,
    loss_from_config,
    make_eval_loss_fn,
    make_multi_step,
    make_optimizer,
    make_train_step,
)
from qst_tpu_torch.train.trainer import Trainer, TrainResult

__all__ = ["Callback", "CheckpointManager", "ClippedAdamW", "EarlyStopping", "SCHEDULES",
           "TrainResult", "TrainState", "Trainer", "create_train_state", "dropout_key",
           "encoder_apply_fn", "get_schedule", "loss_from_config", "make_eval_loss_fn",
           "make_multi_step", "make_optimizer", "make_train_step"]
