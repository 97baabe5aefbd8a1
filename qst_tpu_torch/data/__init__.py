"""Quadruplet data pipeline (counterpart of ``qst_tpu/data``): chunked JSON
storage, the miner-less dataset, collation and prefetch."""

from qst_tpu_torch.data.chunks import ChunkStore, write_chunk, write_meta
from qst_tpu_torch.data.collate import QuadrupletBatch, QuadrupletCollator
from qst_tpu_torch.data.prefetch import PrefetchIterator
from qst_tpu_torch.data.quadruplet_dataset import QuadrupletDataset

__all__ = ["ChunkStore", "PrefetchIterator", "QuadrupletBatch", "QuadrupletCollator",
           "QuadrupletDataset", "write_chunk", "write_meta"]
