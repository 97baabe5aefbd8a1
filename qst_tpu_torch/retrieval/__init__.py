"""Exact retrieval (counterpart of ``qst_tpu/retrieval``)."""

from qst_tpu_torch.retrieval.index import ExactIndex, exact_topk
from qst_tpu_torch.retrieval.retriever import Retriever, load_index, save_index

__all__ = ["ExactIndex", "Retriever", "exact_topk", "load_index", "save_index"]
