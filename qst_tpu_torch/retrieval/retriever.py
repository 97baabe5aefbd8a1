"""Text-level retrieval service: encoder + exact index + persistence —
counterpart of ``qst_tpu/retrieval/retriever.py``.

Ported: ``Retriever`` over an ``ExactIndex`` with ``index_dtype`` float32,
bfloat16 or int8 — ``build``, ``search``, ``search_async``,
``search_stream``, ``save`` / ``load`` — and the module's ``save_index`` /
``load_index``. The artifact layout is the JAX package's (``embeddings.npy``,
``ids.json``, ``index_meta.json``, ``docs.json``), so either package reloads
the other's f32/bf16/int8 index. Index kinds pq, ivf, ivfpq, streaming and
updatable, mesh sharding and cross-encoder reranking raise
``NotImplementedError`` until their slice of the port.
"""

from __future__ import annotations

import json
import os
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from qst_tpu_torch.retrieval.index import ExactIndex

INDEX_FILE = "embeddings.npy"
IDS_FILE = "ids.json"
META_FILE = "index_meta.json"
DOCS_FILE = "docs.json"
INDEX_DTYPES = ("float32", "bfloat16", "int8")


def save_index(path: str, embeddings: np.ndarray, ids: Sequence,
               metadata: Optional[dict] = None) -> None:
    os.makedirs(path, exist_ok=True)
    np.save(os.path.join(path, INDEX_FILE), np.asarray(embeddings))
    with open(os.path.join(path, IDS_FILE), "w") as f:
        json.dump(list(ids), f)
    with open(os.path.join(path, META_FILE), "w") as f:
        json.dump({"n_docs": int(len(ids)),
                   "dim": int(np.asarray(embeddings).shape[1]),
                   **(metadata or {})}, f)


def load_index(path: str, mesh: Any = None, dtype: Optional[str] = None,
               device: Any = "cpu") -> Tuple[ExactIndex, dict]:
    """``dtype`` overrides the storage dtype at load time (e.g. serve an
    f32-saved index as bfloat16 or int8). An index saved as int8 carries its
    quantization scale in the metadata and reloads bit-exactly."""
    with open(os.path.join(path, IDS_FILE)) as f:
        ids = json.load(f)
    with open(os.path.join(path, META_FILE)) as f:
        meta = json.load(f)
    saved = meta.get("dtype", "float32")
    for kind in (saved, dtype):
        if kind is not None and kind not in INDEX_DTYPES:
            raise NotImplementedError(f"index kind {kind!r} is not ported to qst_tpu_torch")
    emb = np.load(os.path.join(path, INDEX_FILE))
    if saved == "int8" and emb.dtype == np.int8:
        if dtype not in (None, "int8"):
            raise ValueError(
                f"index at {path} was saved quantized (int8); it cannot "
                f"be reloaded as {dtype}")
        return ExactIndex(emb, ids=ids, mesh=mesh, dtype="int8",
                          int8_scale=meta["int8_scale"], device=device), meta
    return ExactIndex(emb, ids=ids, mesh=mesh, dtype=dtype or saved,
                      device=device), meta


def encode_keep_device(encode: Any, texts: list):
    """Call an encode function keeping embeddings on the device when it
    takes ``convert_to_numpy`` (``SentenceEncoder.encode`` does); plain
    ``encode(texts)`` callables still work."""
    import inspect

    try:
        explicit = "convert_to_numpy" in inspect.signature(encode).parameters
    except (TypeError, ValueError):  # builtins / C callables
        explicit = False
    if explicit:
        return encode(texts, convert_to_numpy=False)
    return encode(texts)


class Retriever:
    """Encode-and-search by text.

    encoder: anything with ``encode(texts) -> (N, D)`` (``SentenceEncoder``).
    The index lives on the encoder's device (``encoder.device``, else the
    CPU). Corpus docs may carry external ids."""

    def __init__(self, encoder: Any, mesh: Any = None, score: str = "cos_sim",
                 index_dtype: str = "float32"):
        if mesh is not None:
            raise NotImplementedError("sharded retrieval (mesh=) is not ported")
        if index_dtype not in INDEX_DTYPES:
            raise NotImplementedError(
                f"index_dtype {index_dtype!r} is not ported (float32, bfloat16, int8)")
        self.encoder = encoder
        self.mesh = None
        self.score = score
        self.index_dtype = index_dtype
        self.device = torch.device(getattr(encoder, "device", "cpu"))
        self._index: Optional[ExactIndex] = None
        self._doc_texts: List[str] = []
        self._pos_of: Optional[dict] = None

    @property
    def index(self) -> Optional[ExactIndex]:
        return self._index

    @index.setter
    def index(self, value) -> None:
        # a new index invalidates the cached id → position map
        self._index = value
        self._pos_of = None

    def _pos(self) -> dict:
        """id → corpus position, built once per index."""
        if self._pos_of is None:
            self._pos_of = {i: p for p, i in enumerate(self.index.ids)}
        return self._pos_of

    def build(self, docs: Sequence[str],
              ids: Optional[Sequence] = None) -> "Retriever":
        # device-resident handoff: encoder → index with no host round trip
        emb = encode_keep_device(self.encoder.encode, list(docs))
        ids = list(ids) if ids is not None else list(range(len(docs)))
        self.index = ExactIndex(emb, ids=ids, dtype=self.index_dtype,
                                device=self.device)
        self._doc_texts = list(docs)
        return self

    def save(self, path: str) -> None:
        if self.index is None:
            raise RuntimeError("no index built")
        emb = self.index.embeddings
        meta = {"score": self.score}
        if emb.dtype == torch.int8:
            # the quantized rows + scale reload bit-exactly
            meta.update(dtype="int8", int8_scale=self.index._int8_scale)
        elif emb.dtype != torch.float32:
            # .npy has no portable bf16: store f32, reload re-casts exactly
            meta["dtype"] = str(emb.dtype).removeprefix("torch.")
            emb = emb.float()
        save_index(path, emb.cpu().numpy(), self.index.ids, meta)
        with open(os.path.join(path, DOCS_FILE), "w") as f:
            json.dump(self._doc_texts, f)

    def load(self, path: str) -> "Retriever":
        self.index, meta = load_index(
            path, dtype=None if self.index_dtype == "float32" else self.index_dtype,
            device=self.device)
        docs_path = os.path.join(path, DOCS_FILE)
        if os.path.isfile(docs_path):
            with open(docs_path) as f:
                self._doc_texts = json.load(f)
        self.score = meta.get("score", self.score)
        return self

    def _dispatch(self, queries: List[str], k: int):
        """Encode + search without waiting for the device: the returned
        tensors are still being computed when this returns."""
        q_emb = encode_keep_device(self.encoder.encode, queries)
        return self.index._device_search(q_emb, k, self.score, 131072, "auto")

    def _rows(self, state, return_texts: bool, pos_of) -> list:
        """Copy one batch's (scores, ids) to the host (this waits for the
        device) and unpack them into (doc_id, score[, text]) rows."""
        scores, idx = (t.cpu().numpy() for t in state)
        rows = []
        for qi in range(idx.shape[0]):
            row = []
            for j, s in zip(idx[qi], scores[qi]):
                doc_id = self.index.ids[int(j)]
                entry = (doc_id, float(s))
                if return_texts and self._doc_texts:
                    entry = (*entry, self._doc_texts[pos_of[doc_id]])
                row.append(entry)
            rows.append(row)
        return rows

    def _require_index(self) -> None:
        if self.index is None:
            raise RuntimeError("no index built or loaded")

    def search_async(self, queries: Sequence[str], k: int = 10,
                     return_texts: bool = False):
        """Dispatch encode + search for one batch now and return a zero-arg
        callable that materializes the rows — the serving split-phase path
        (``DynamicBatcher(finalize_fn=...)``): the batcher dispatches batch
        N+1 while batch N's results copy back. Same rows as :meth:`search`."""
        self._require_index()
        pos_of = self._pos() if (return_texts and self._doc_texts) else None
        state = self._dispatch(list(queries), k)
        return lambda: self._rows(state, return_texts, pos_of)

    def search_stream(self, query_batches, k: int = 10, depth: int = 4,
                      return_texts: bool = False):
        """Pipelined text → results loop: yields one result list per batch
        of query texts, in input order, with up to ``depth`` batches queued
        on the device."""
        self._require_index()
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        pos_of = self._pos() if (return_texts and self._doc_texts) else None
        pending: list = []
        for queries in query_batches:
            pending.append(self._dispatch(list(queries), k))
            if len(pending) >= depth:
                yield self._rows(pending.pop(0), return_texts, pos_of)
        while pending:
            yield self._rows(pending.pop(0), return_texts, pos_of)

    def search(self, queries: Sequence[str], k: int = 10,
               return_texts: bool = False, rerank_k: int = 0):
        """→ list per query of (doc_id, score[, text]) tuples. Cross-encoder
        reranking (``rerank_k``) is not ported."""
        if rerank_k:
            raise NotImplementedError("cross-encoder reranking is not ported")
        self._require_index()
        return self.search_async(queries, k=k, return_texts=return_texts)()
