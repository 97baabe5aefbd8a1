"""Core configuration (counterpart of ``qst_tpu/core``)."""

from qst_tpu_torch.core.config import EncoderConfig

__all__ = ["EncoderConfig"]
