"""Core configuration and telemetry (counterpart of ``qst_tpu/core``)."""

from qst_tpu_torch.core.config import DataConfig, EncoderConfig, LossConfig, TrainConfig

__all__ = ["DataConfig", "EncoderConfig", "LossConfig", "TrainConfig"]
