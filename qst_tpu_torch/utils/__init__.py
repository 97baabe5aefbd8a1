"""Host utilities — counterparts of ``qst_tpu/utils``."""

from qst_tpu_torch.utils.sync import synchronized

__all__ = ["synchronized"]
