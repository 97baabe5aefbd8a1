"""HTTP serving with dynamic micro-batching (counterpart of
``qst_tpu/serve``)."""

from qst_tpu_torch.serve.batcher import DynamicBatcher
from qst_tpu_torch.serve.server import RetrievalServer

__all__ = ["DynamicBatcher", "RetrievalServer"]
