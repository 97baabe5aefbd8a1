"""Exact, IVF, PQ, IVF-PQ, streamed and updatable retrieval (counterpart of
``qst_tpu/retrieval``)."""

from qst_tpu_torch.retrieval.index import ExactIndex, exact_topk
from qst_tpu_torch.retrieval.ivf import IVFIndex, kmeans
from qst_tpu_torch.retrieval.ivfpq import IVFPQIndex
from qst_tpu_torch.retrieval.pq import PQIndex
from qst_tpu_torch.retrieval.retriever import Retriever, load_index, save_index
from qst_tpu_torch.retrieval.streaming import StreamingExactIndex
from qst_tpu_torch.retrieval.updatable import UpdatableIndex

__all__ = ["ExactIndex", "IVFIndex", "IVFPQIndex", "PQIndex", "Retriever",
           "StreamingExactIndex", "UpdatableIndex", "exact_topk", "kmeans", "load_index",
           "save_index"]
