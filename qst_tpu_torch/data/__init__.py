"""Quadruplet data pipeline (counterpart of ``qst_tpu/data``): chunked JSON
storage, negative mining, the dataset, collation and prefetch."""

from qst_tpu_torch.data.chunks import ChunkStore, write_chunk, write_meta
from qst_tpu_torch.data.collate import QuadrupletBatch, QuadrupletCollator
from qst_tpu_torch.data.mining import (
    HARD_CONTRASTIVE_TEST,
    HARD_CONTRASTIVE_TRAIN,
    RANDOM,
    EmbeddingTable,
    NegativeMiner,
    mine_negatives,
)
from qst_tpu_torch.data.prefetch import PrefetchIterator
from qst_tpu_torch.data.quadruplet_dataset import QuadrupletDataset

__all__ = ["ChunkStore", "EmbeddingTable", "HARD_CONTRASTIVE_TEST", "HARD_CONTRASTIVE_TRAIN",
           "NegativeMiner", "PrefetchIterator", "QuadrupletBatch", "QuadrupletCollator",
           "QuadrupletDataset", "RANDOM", "mine_negatives", "write_chunk", "write_meta"]
