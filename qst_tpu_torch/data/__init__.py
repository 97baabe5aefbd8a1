"""Quadruplet data pipeline (counterpart of ``qst_tpu/data``): chunked JSON
storage, negative mining, the dataset, collation and prefetch."""

from qst_tpu_torch.data.chunks import (
    ChunkStore,
    chunk_path,
    discover_chunks,
    read_meta,
    write_chunk,
    write_meta,
)
from qst_tpu_torch.data.collate import QuadrupletBatch, QuadrupletCollator, select_single_example
from qst_tpu_torch.data.mining import (
    HARD_CONTRASTIVE_TEST,
    HARD_CONTRASTIVE_TRAIN,
    RANDOM,
    EmbeddingTable,
    NegativeMiner,
    mine_negatives,
)
from qst_tpu_torch.data.prefetch import PrefetchIterator
from qst_tpu_torch.data.quadruplet_dataset import QuadrupletDataset, choose_examples

__all__ = ["ChunkStore", "EmbeddingTable", "HARD_CONTRASTIVE_TEST", "HARD_CONTRASTIVE_TRAIN",
           "NegativeMiner", "PrefetchIterator", "QuadrupletBatch", "QuadrupletCollator",
           "QuadrupletDataset", "RANDOM", "choose_examples", "chunk_path", "discover_chunks",
           "mine_negatives", "read_meta", "select_single_example", "write_chunk", "write_meta"]
