"""Text-level retrieval service: encoder + index + persistence —
counterpart of ``qst_tpu/retrieval/retriever.py``.

Ported: ``Retriever`` over an ``ExactIndex`` (``index_dtype`` float32,
bfloat16 or int8), an ``IVFIndex`` (``index_dtype="ivf"``) or an
``UpdatableIndex`` (``build_updatable`` / ``to_updatable``, ``add_docs`` /
``remove_docs``) — ``build``, ``search``, ``search_async``,
``search_stream``, ``save`` / ``load`` — and the module's ``save_index`` /
``load_index``. The artifact layout is the JAX package's (``embeddings.npy``
or ``ivf_*.npy``, ``ids.json``, ``index_meta.json``, ``docs.json``), so
either package reloads the other's index. Index kinds pq, ivfpq and
streaming, mesh sharding and cross-encoder reranking raise
``NotImplementedError`` until their slice of the port.
"""

from __future__ import annotations

import json
import os
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from qst_tpu_torch.core.device import resolve_device
from qst_tpu_torch.retrieval.index import ExactIndex
from qst_tpu_torch.retrieval.ivf import IVFIndex
from qst_tpu_torch.retrieval.updatable import EmptyIndexError, UpdatableIndex

INDEX_FILE = "embeddings.npy"
IDS_FILE = "ids.json"
META_FILE = "index_meta.json"
DOCS_FILE = "docs.json"
IVF_CENTROIDS_FILE = "ivf_centroids.npy"
IVF_CELLS_FILE = "ivf_cells.npy"
IVF_CELL_IDS_FILE = "ivf_cell_ids.npy"
IVF_FILL_FILE = "ivf_fill.npy"
INDEX_DTYPES = ("float32", "bfloat16", "int8", "ivf")
NOT_PORTED = ("pq", "ivfpq", "streaming")


def _not_ported(kind: str) -> NotImplementedError:
    return NotImplementedError(
        f"index kind {kind!r} is not ported to qst_tpu_torch "
        f"(ported: {', '.join(INDEX_DTYPES)})")


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
               device: Any = None) -> Tuple[Any, dict]:
    """``dtype`` overrides the storage dtype at load time (e.g. serve an
    f32-saved index as bfloat16 or int8). An index saved as int8 carries its
    quantization scale in the metadata and reloads bit-exactly; one saved as
    "ivf" reloads its cells, centroids and fill counts into an
    :class:`IVFIndex` without re-clustering. The index lives on ``device``
    (default: the GPU)."""
    device = resolve_device(device)
    with open(os.path.join(path, IDS_FILE)) as f:
        ids = json.load(f)
    with open(os.path.join(path, META_FILE)) as f:
        meta = json.load(f)
    saved = meta.get("dtype", "float32")
    for kind in (saved, dtype):
        if kind is not None and kind not in INDEX_DTYPES:
            raise _not_ported(kind)
    if saved == "ivf":
        if dtype not in (None, "ivf"):
            raise ValueError(
                f"index at {path} was saved as an IVF index; it cannot "
                f"be reloaded as {dtype}")
        return IVFIndex.from_arrays(
            np.load(os.path.join(path, IVF_CENTROIDS_FILE)),
            np.load(os.path.join(path, IVF_CELLS_FILE)),
            np.load(os.path.join(path, IVF_CELL_IDS_FILE)),
            np.load(os.path.join(path, IVF_FILL_FILE)), ids=ids, mesh=mesh,
            default_n_probe=int(meta.get("n_probe", 8)),
            dtype=meta.get("cells_dtype", "float32"), device=device), meta
    if dtype == "ivf":
        raise ValueError(
            f"index at {path} was not saved as an IVF index — rebuild "
            "it with index_dtype='ivf'")
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


def _host_f32(emb) -> np.ndarray:
    if isinstance(emb, torch.Tensor):
        return emb.float().cpu().numpy()
    return np.asarray(emb, np.float32)


class Retriever:
    """Encode-and-search by text.

    encoder: anything with ``encode(texts) -> (N, D)`` (``SentenceEncoder``).
    The index lives on ``device``: by default the encoder's
    (``encoder.device``), and the GPU for an encoder that names none.
    Corpus docs may carry external ids."""

    def __init__(self, encoder: Any, mesh: Any = None, score: str = "cos_sim",
                 index_dtype: str = "float32", ivf_clusters: int = 256,
                 ivf_probe: int = 8, device: Any = None):
        """index_dtype: storage dtype or kind for built/loaded indexes —
        "bfloat16" for tensor-core scoring, "int8" for half the memory again
        (quantized-exact ranking; see ExactIndex), or "ivf" for the
        approximate k-means-cell index (``ivf_clusters`` cells,
        ``ivf_probe`` of them scanned per query; see IVFIndex)."""
        if mesh is not None:
            raise NotImplementedError("sharded retrieval (mesh=) is not ported")
        if index_dtype not in INDEX_DTYPES:
            raise _not_ported(index_dtype)
        self.encoder = encoder
        self.mesh = None
        self.score = score
        self.index_dtype = index_dtype
        self.ivf_clusters = ivf_clusters
        self.ivf_probe = ivf_probe
        if device is None:
            device = getattr(encoder, "device", None)
        self.device = resolve_device(device)
        self._index: Optional[Any] = None
        self._doc_texts: List[str] = []
        self._texts_by_id: dict = {}
        self._next_auto_id = 0
        self._pos_of: Optional[dict] = None

    @property
    def index(self) -> Optional[Any]:
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

    # ---------------- the updatable corpus ------------------------------
    def build_updatable(self, docs: Sequence[str] = (),
                        ids: Optional[Sequence] = None,
                        capacity: int = 65536) -> "Retriever":
        """Serve a mutable corpus: back the retriever with an
        :class:`UpdatableIndex` (fixed-capacity buffer), then grow/shrink it
        online via :meth:`add_docs` / :meth:`remove_docs` — the
        RetrievalServer exposes these as POST/DELETE /docs. The buffer
        stores L2-normalized rows (cosine semantics); dot_score is accepted
        only for unit-norm embeddings (checked at build and on every add)."""
        probe = _host_f32(self.encoder.encode(["dimension probe"]))
        self._check_updatable_score(probe)
        self.index = UpdatableIndex(int(probe.shape[1]), capacity=capacity,
                                    device=self.device)
        self._texts_by_id = {}
        self._next_auto_id = 0
        if docs:
            self.add_docs(docs, ids)
        return self

    def to_updatable(self, capacity: int = 0) -> "Retriever":
        """Convert a built/loaded static index into an updatable one in
        place (reuses the existing embeddings — no re-encode): the serving
        path for ``index_main serve --updatable``. ``capacity`` defaults
        to 2× the corpus (min 65536)."""
        if self.index is None:
            raise RuntimeError("no index built or loaded")
        if self._is_updatable():
            return self
        if isinstance(self.index, IVFIndex):
            emb = self.index.reconstruct_rows()
        else:
            emb = _host_f32(self.index.embeddings)[: self.index.n_docs]
        self._check_updatable_score(emb)   # full corpus: one host pass
        ids = list(self.index.ids)
        capacity = capacity or max(65536, 2 * len(ids))
        new = UpdatableIndex(emb.shape[1], capacity=capacity, device=self.device)
        new.add(emb, ids)
        self._texts_by_id = (dict(zip(ids, self._doc_texts))
                             if self._doc_texts else {})
        self._next_auto_id = 1 + max(
            [-1] + [i for i in ids if isinstance(i, int)])
        self.index = new   # setter invalidates the id->position cache
        return self

    def _check_updatable_score(self, sample: np.ndarray) -> None:
        """The updatable buffer stores L2-normalized rows (cosine
        semantics). cos_sim is always fine; dot_score is only exact when
        the vectors are already unit-norm — otherwise normalization would
        silently rescale every dot score, changing rankings."""
        if self.score == "cos_sim":
            return
        if self.score != "dot_score":
            raise ValueError(
                "updatable retrieval serves cos_sim/dot_score only "
                f"(normalized buffer), got {self.score!r}")
        norms = np.linalg.norm(np.asarray(sample, np.float32), axis=-1)
        if norms.size and float(np.abs(norms - 1.0).max()) > 1e-2:
            raise ValueError(
                "dot_score over an updatable index needs unit-norm "
                "embeddings (the buffer normalizes rows, which would "
                "change non-normalized dot rankings) — use score='cos_sim' "
                "or normalize the encoder output")

    def _is_updatable(self) -> bool:
        return isinstance(self.index, UpdatableIndex)

    def add_docs(self, docs: Sequence[str],
                 ids: Optional[Sequence] = None) -> list:
        """Add documents to an updatable index (encode → buffer write).
        → the assigned ids (auto-assigned ints when ``ids`` is None)."""
        if not self._is_updatable():
            raise RuntimeError(
                "add_docs needs an updatable index (build_updatable())")
        docs = list(docs)
        if ids is None:
            ids = list(range(self._next_auto_id,
                             self._next_auto_id + len(docs)))
        emb = encode_keep_device(self.encoder.encode, docs)
        if self.score == "dot_score":
            # every add re-validates: a single build-time probe can't
            # vouch for later embeddings' norms
            self._check_updatable_score(_host_f32(emb))
        self.index.add(emb, list(ids))        # validates before publish
        self._next_auto_id = max(
            [self._next_auto_id] + [i + 1 for i in ids
                                    if isinstance(i, int)])
        # in-place insertion is snapshot-safe (keys only appear; readers
        # .get by id) and O(batch) — only removals must preserve the old
        # map (see remove_docs)
        for i, t in zip(ids, docs):
            self._texts_by_id[i] = t
        return list(ids)

    def remove_docs(self, ids: Sequence) -> None:
        if not self._is_updatable():
            raise RuntimeError(
                "remove_docs needs an updatable index (build_updatable())")
        self.index.remove(list(ids))
        # copy-on-write (O(corpus), removals are the rare operation): an
        # in-flight search holding the pre-remove snapshot keeps resolving
        # the removed docs' texts from the old map
        gone = set(ids)
        self._texts_by_id = {i: t for i, t in self._texts_by_id.items()
                             if i not in gone}

    # ---------------- build / persistence -------------------------------
    def build(self, docs: Sequence[str],
              ids: Optional[Sequence] = None) -> "Retriever":
        # device-resident handoff: encoder → index with no host round trip
        emb = encode_keep_device(self.encoder.encode, list(docs))
        ids = list(ids) if ids is not None else list(range(len(docs)))
        if self.index_dtype == "ivf":
            self.index = IVFIndex(emb, n_clusters=self.ivf_clusters, ids=ids,
                                  default_n_probe=self.ivf_probe, device=self.device)
        else:
            self.index = ExactIndex(emb, ids=ids, dtype=self.index_dtype,
                                    device=self.device)
        self._doc_texts = list(docs)
        return self

    def _save_docs(self, path: str, texts: list) -> None:
        with open(os.path.join(path, DOCS_FILE), "w") as f:
            json.dump(texts, f)

    def save(self, path: str) -> None:
        if self.index is None:
            raise RuntimeError("no index built")
        if self._is_updatable():
            # persist a static snapshot (reloads as an ExactIndex)
            buffer, ids, _ = self.index._state
            save_index(path, buffer[: len(ids)].cpu().numpy(), list(ids),
                       {"score": self.score})
            texts = [self._texts_by_id.get(i) for i in ids]
            if all(t is not None for t in texts):
                self._save_docs(path, texts)
            return
        if isinstance(self.index, IVFIndex):
            # cells persist f32 (.npy has no portable bf16; the dtype is
            # recorded and reload re-casts exactly)
            os.makedirs(path, exist_ok=True)
            cells = self.index.cells
            cells_dtype = "bfloat16" if cells.dtype != torch.float32 else "float32"
            np.save(os.path.join(path, IVF_CELLS_FILE), cells.float().cpu().numpy())
            np.save(os.path.join(path, IVF_CENTROIDS_FILE),
                    self.index.centroids.float().cpu().numpy())
            np.save(os.path.join(path, IVF_CELL_IDS_FILE),
                    self.index.cell_ids.to(torch.int32).cpu().numpy())
            np.save(os.path.join(path, IVF_FILL_FILE),
                    self.index.fill.to(torch.int32).cpu().numpy())
            with open(os.path.join(path, IDS_FILE), "w") as f:
                json.dump(list(self.index.ids), f)
            with open(os.path.join(path, META_FILE), "w") as f:
                json.dump({"n_docs": int(self.index.n_docs),
                           "dim": int(cells.shape[-1]), "dtype": "ivf",
                           "cells_dtype": cells_dtype,
                           "n_probe": int(self.index.default_n_probe),
                           "cell_budget": int(self.index.cell_budget),
                           "score": self.score}, f)
            self._save_docs(path, self._doc_texts)
            return
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
        self._save_docs(path, self._doc_texts)

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

    # ---------------- search --------------------------------------------
    def _dispatch(self, queries: List[str], k: int):
        """Encode + search without waiting for the device: the returned
        tensors are still being computed when this returns."""
        q_emb = encode_keep_device(self.encoder.encode, queries)
        dev_search = getattr(self.index, "_device_search_retriever",
                             self.index._device_search)
        return dev_search(q_emb, k, self.score, 131072, "auto")

    def _rows(self, state, return_texts: bool, pos_of) -> list:
        """Copy one batch's (scores, ids) to the host (this waits for the
        device) and unpack them into (doc_id, score[, text]) rows."""
        scores, idx = (t.cpu().numpy() for t in state)
        rows = []
        for qi in range(idx.shape[0]):
            row = []
            for j, s in zip(idx[qi], scores[qi]):
                if j < 0:   # IVF can return fewer than k real hits
                    continue
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
        N+1 while batch N's results copy back. An updatable index has no
        single-dispatch path (its buffer changes between batches): the
        callable then runs a plain :meth:`search`. Same rows as
        :meth:`search`."""
        self._require_index()
        queries = list(queries)
        if self._is_updatable():
            return lambda: self.search(queries, k=k, return_texts=return_texts)
        pos_of = self._pos() if (return_texts and self._doc_texts) else None
        state = self._dispatch(queries, k)
        return lambda: self._rows(state, return_texts, pos_of)

    def search_stream(self, query_batches, k: int = 10, depth: int = 4,
                      return_texts: bool = False):
        """Pipelined text → results loop: yields one result list per batch
        of query texts, in input order, with up to ``depth`` batches queued
        on the device."""
        self._require_index()
        if self._is_updatable():
            raise RuntimeError(
                "search_stream needs a static index (the updatable "
                "buffer mutates between batches); use search()")
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

    def _search_updatable(self, queries: List[str], k: int, return_texts: bool):
        # snapshot the text map before the search: removals replace the map
        # (copy-on-write), so a racing DELETE cannot null out texts for docs
        # the index snapshot legitimately returns; adds insert in place,
        # which is also safe (keys only appear)
        text_of = self._texts_by_id.get
        has_texts = bool(self._texts_by_id)
        q_emb = encode_keep_device(self.encoder.encode, queries)
        try:
            scores, ids = self.index.search(q_emb, k=k)
        except EmptyIndexError:
            # corpus empty — including emptied by a delete racing this very
            # call (the snapshot decides, not a pre-check): an empty serving
            # corpus answers with no hits, not a 500
            return [[] for _ in queries]
        out = []
        for qi in range(len(queries)):
            row = []
            for doc_id, s in zip(ids[qi], scores[qi]):
                entry = (doc_id, float(s))
                if return_texts and has_texts:
                    entry = (*entry, text_of(doc_id))
                row.append(entry)
            out.append(row)
        return out

    def search(self, queries: Sequence[str], k: int = 10,
               return_texts: bool = False, rerank_k: int = 0):
        """→ list per query of (doc_id, score[, text]) tuples; an IVF row
        is shorter than k when the probed cells held fewer documents.
        Cross-encoder reranking (``rerank_k``) is not ported."""
        if rerank_k:
            raise NotImplementedError("cross-encoder reranking is not ported")
        self._require_index()
        if self._is_updatable():
            return self._search_updatable(list(queries), k, return_texts)
        return self.search_async(queries, k=k, return_texts=return_texts)()
