"""Text-level retrieval service: encoder + index + persistence —
counterpart of ``qst_tpu/retrieval/retriever.py``.

``Retriever`` over an ``ExactIndex`` (``index_dtype`` float32, bfloat16 or
int8), an ``IVFIndex`` ("ivf"), a ``PQIndex`` ("pq", ``pq_m`` bytes a doc,
refine rows kept), an ``IVFPQIndex`` ("ivfpq", ``ivfpq_bits`` 8 or 4), a
``StreamingExactIndex`` ("streaming": ``build_to_disk`` writes the
embeddings to a memmap, ``load`` streams them) or an ``UpdatableIndex``
(``build_updatable`` / ``to_updatable``, ``add_docs`` / ``remove_docs``) —
``build``, ``search``, ``search_async``, ``search_stream``, ``save`` /
``load`` — and the module's ``save_index`` / ``load_index``. PQ and IVF-PQ
searches re-rank ``DEFAULT_REFINE·k`` candidates exactly from their refine
rows by default, in ``search`` and in the finishers of ``search_async`` and
``search_stream``. The artifact layout is the JAX package's
(``embeddings.npy``, ``ivf_*.npy``, ``pq_*.npy``, ``ivfpq_*.npy``,
``ids.json``, ``index_meta.json``, ``docs.json``), so either package
reloads the other's index. ``reranker=`` (a ``CrossEncoder``) and
``search(..., rerank_k=)`` give two-stage retrieval: the index's top
``max(k, rerank_k)`` candidates re-scored by the cross-encoder. ``mesh=`` (a
``core/meshes.py`` mesh) builds, loads and searches every kind sharded over
it; ``save`` writes the real rows and cells, never a mesh's padding.
"""

from __future__ import annotations

import json
import os
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from qst_tpu_torch.core.device import resolve_device
from qst_tpu_torch.core.meshes import as_mesh, gathered
from qst_tpu_torch.retrieval.index import ExactIndex
from qst_tpu_torch.retrieval.ivf import IVFIndex
from qst_tpu_torch.retrieval.ivfpq import IVFPQIndex
from qst_tpu_torch.retrieval.pq import PQIndex, _host_f32, refine_pair
from qst_tpu_torch.retrieval.streaming import StreamingExactIndex
from qst_tpu_torch.retrieval.updatable import EmptyIndexError, UpdatableIndex

INDEX_FILE = "embeddings.npy"
IDS_FILE = "ids.json"
META_FILE = "index_meta.json"
DOCS_FILE = "docs.json"
IVF_CENTROIDS_FILE = "ivf_centroids.npy"
IVF_CELLS_FILE = "ivf_cells.npy"
IVF_CELL_IDS_FILE = "ivf_cell_ids.npy"
IVF_FILL_FILE = "ivf_fill.npy"
PQ_CODES_FILE = "pq_codes.npy"
PQ_CODEBOOKS_FILE = "pq_codebooks.npy"
PQ_ROWS_FILE = "pq_refine_rows.npy"
PQ_ROTATION_FILE = "pq_rotation.npy"
IVFPQ_CENTROIDS_FILE = "ivfpq_centroids.npy"
IVFPQ_CODES_FILE = "ivfpq_cell_codes.npy"
IVFPQ_CELL_IDS_FILE = "ivfpq_cell_ids.npy"
IVFPQ_CODEBOOKS_FILE = "ivfpq_codebooks.npy"
IVFPQ_FILL_FILE = "ivfpq_fill.npy"
IVFPQ_ROWS_FILE = "ivfpq_refine_rows.npy"
INDEX_DTYPES = ("float32", "bfloat16", "int8", "pq", "ivf", "ivfpq", "streaming")


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
    f32-saved index as bfloat16 or int8, or stream it with "streaming"). An
    index saved as int8 carries its quantization scale in the metadata and
    reloads bit-exactly; one saved as "ivf", "pq" or "ivfpq" reloads its
    arrays (and refine rows where they were saved) without re-clustering or
    re-encoding. The index lives on ``device`` (default: the GPU, or a
    mesh's first device), sharded over ``mesh`` when one is given; a
    streamed corpus stays on disk, memory-mapped."""
    mesh = as_mesh(mesh)
    device = resolve_device(device if device is not None or mesh is None
                            else mesh.home)
    with open(os.path.join(path, IDS_FILE)) as f:
        ids = json.load(f)
    with open(os.path.join(path, META_FILE)) as f:
        meta = json.load(f)
    saved = meta.get("dtype", "float32")

    def npy(name: str, optional: bool = False):
        full = os.path.join(path, name)
        return None if optional and not os.path.isfile(full) else np.load(full)

    for kind, saved_as in (("pq", "product-quantized"), ("ivf", "as an IVF index"),
                           ("ivfpq", "as an IVF-PQ index")):
        if saved == kind and dtype not in (None, kind):
            raise ValueError(f"index at {path} was saved {saved_as}; it cannot be "
                             f"reloaded as {dtype}")
        if dtype == kind and saved != kind:
            raise ValueError(f"index at {path} was not saved {saved_as} — rebuild it "
                             f"with index_dtype='{kind}'")
    if saved == "pq":
        return PQIndex.from_codes(npy(PQ_CODES_FILE), npy(PQ_CODEBOOKS_FILE), ids=ids,
                                  mesh=mesh, refine_rows=npy(PQ_ROWS_FILE, True),
                                  rotation=npy(PQ_ROTATION_FILE, True), device=device), meta
    if saved == "ivf":
        return IVFIndex.from_arrays(
            npy(IVF_CENTROIDS_FILE), npy(IVF_CELLS_FILE), npy(IVF_CELL_IDS_FILE),
            npy(IVF_FILL_FILE), ids=ids, mesh=mesh,
            default_n_probe=int(meta.get("n_probe", 8)),
            dtype=meta.get("cells_dtype", "float32"), device=device), meta
    if saved == "ivfpq":
        return IVFPQIndex.from_arrays(
            npy(IVFPQ_CENTROIDS_FILE), npy(IVFPQ_CODES_FILE), npy(IVFPQ_CELL_IDS_FILE),
            npy(IVFPQ_CODEBOOKS_FILE), npy(IVFPQ_FILL_FILE), ids=ids, mesh=mesh,
            default_n_probe=int(meta.get("n_probe", 8)),
            residual=bool(meta.get("residual", True)),
            refine_rows=npy(IVFPQ_ROWS_FILE, True), bits=int(meta.get("bits", 8)),
            device=device), meta
    if dtype == "streaming":
        # a saved corpus larger than device memory: memory-map the matrix and
        # stream it through double-buffered tiles
        if saved == "int8":
            raise ValueError(
                "an int8-saved index uses its own quantization scale and "
                "cannot stream verbatim — save float embeddings (or use "
                "StreamingExactIndex.quantize_host for a streamable int8 "
                "corpus)")
        return StreamingExactIndex.from_npy(os.path.join(path, INDEX_FILE), ids=ids,
                                            mesh=mesh, device=device), meta
    emb = npy(INDEX_FILE)
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
    The index lives on ``device``: by default the encoder's
    (``encoder.device``), and the GPU for an encoder that names none.
    Corpus docs may carry external ids."""

    def __init__(self, encoder: Any, mesh: Any = None, score: str = "cos_sim",
                 reranker: Any = None, index_dtype: str = "float32", ivf_clusters: int = 256,
                 ivf_probe: int = 8, pq_m: int = 48, pq_rotate: bool = False,
                 ivfpq_bits: int = 8, device: Any = None):
        """reranker: optional cross-encoder with ``predict(pairs) -> scores``
        (``models/cross_encoder.py``'s ``CrossEncoder``) for two-stage
        retrieval: dense top-N candidates → pair re-scoring.

        index_dtype: storage dtype or kind for built/loaded indexes —
        "bfloat16" for tensor-core scoring, "int8" for half the memory again
        (quantized-exact ranking; see ExactIndex), "ivf" for the approximate
        k-means-cell index (``ivf_clusters`` cells, ``ivf_probe`` of them
        scanned per query; see IVFIndex), "pq" for a product-quantized index
        (``pq_m`` bytes a doc on the device, the normalized originals in host
        memory for the exact re-rank; ``pq_rotate`` quantizes in a random
        rotation; see PQIndex), "ivfpq" for PQ codes in k-means cells
        (``ivfpq_bits`` 8, or 4 for packed nibbles at the same bytes a doc;
        see IVFPQIndex), or "streaming" for a corpus that stays on disk
        (``build_to_disk``; see StreamingExactIndex)."""
        mesh = as_mesh(mesh)
        if index_dtype not in INDEX_DTYPES:
            raise ValueError(f"index_dtype must be one of {INDEX_DTYPES}, got {index_dtype!r}")
        self.encoder = encoder
        self.mesh = mesh
        self.score = score
        self.reranker = reranker
        self.index_dtype = index_dtype
        self.ivf_clusters = ivf_clusters
        self.ivf_probe = ivf_probe
        self.pq_m = pq_m
        self.pq_rotate = pq_rotate
        self.ivfpq_bits = ivfpq_bits
        if device is None:
            device = mesh.home if mesh is not None else getattr(encoder, "device", None)
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
        if isinstance(self.index, (PQIndex, IVFPQIndex)):
            if self.index._refine_rows is not None:
                emb = self.index.refine_rows_f32()
            elif isinstance(self.index, IVFPQIndex):
                emb = self.index.reconstruct_rows()
            else:
                raise RuntimeError(
                    "a PQ index without refine rows holds only codes — "
                    "rebuild with keep_rows=True (the Retriever build "
                    "default) to convert to an updatable index")
        elif isinstance(self.index, IVFIndex):
            emb = self.index.reconstruct_rows()
        else:
            emb = _host_f32(gathered(self.index.embeddings))[: self.index.n_docs]
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
        where = {"mesh": self.mesh, "device": self.device}
        if self.index_dtype == "pq":
            self.index = PQIndex(emb, m=self.pq_m, ids=ids, keep_rows=True,
                                 rotate=self.pq_rotate, **where)
        elif self.index_dtype == "ivf":
            self.index = IVFIndex(emb, n_clusters=self.ivf_clusters, ids=ids,
                                  default_n_probe=self.ivf_probe, **where)
        elif self.index_dtype == "ivfpq":
            self.index = IVFPQIndex(emb, n_clusters=self.ivf_clusters, m=self.pq_m, ids=ids,
                                    default_n_probe=self.ivf_probe, keep_rows=True,
                                    bits=self.ivfpq_bits, **where)
        else:
            self.index = ExactIndex(emb, ids=ids, dtype=self.index_dtype, **where)
        self._doc_texts = list(docs)
        return self

    def build_to_disk(self, docs: Sequence[str], path: str,
                      ids: Optional[Sequence] = None,
                      encode_batch: int = 8192) -> "Retriever":
        """Build a disk-backed index artifact incrementally: documents are
        encoded in ``encode_batch``-text chunks and written straight into a
        memory-mapped ``embeddings.npy`` (the layout of :meth:`save`, texts
        included), so a corpus whose embedding matrix exceeds host or device
        memory is indexed end to end. The retriever is left holding the
        memmap-backed :class:`StreamingExactIndex`."""
        docs = list(docs)
        if not docs:
            raise ValueError("no documents to index")
        ids = list(ids) if ids is not None else list(range(len(docs)))
        if len(ids) != len(docs):
            raise ValueError("ids length mismatch")
        os.makedirs(path, exist_ok=True)
        emb_path = os.path.join(path, INDEX_FILE)
        mm = None
        for lo in range(0, len(docs), encode_batch):
            chunk = _host_f32(self.encoder.encode(docs[lo:lo + encode_batch]))
            if mm is None:
                mm = np.lib.format.open_memmap(emb_path, mode="w+", dtype=np.float32,
                                               shape=(len(docs), chunk.shape[1]))
            mm[lo:lo + chunk.shape[0]] = chunk
        mm.flush()
        with open(os.path.join(path, IDS_FILE), "w") as f:
            json.dump(ids, f)
        with open(os.path.join(path, META_FILE), "w") as f:
            json.dump({"n_docs": len(ids), "dim": int(mm.shape[1]), "score": self.score}, f)
        self._save_docs(path, docs)
        del mm
        self.index = StreamingExactIndex.from_npy(emb_path, ids=ids, mesh=self.mesh,
                                                  device=self.device)
        self._doc_texts = docs
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
            # (the real cells: a mesh's padded ones are left out)
            os.makedirs(path, exist_ok=True)
            C = int(self.index.fill.shape[0])
            cells = gathered(self.index.cells)[:C]
            cells_dtype = "bfloat16" if cells.dtype != torch.float32 else "float32"
            np.save(os.path.join(path, IVF_CELLS_FILE), cells.float().cpu().numpy())
            np.save(os.path.join(path, IVF_CENTROIDS_FILE),
                    self.index.centroids.float().cpu().numpy())
            np.save(os.path.join(path, IVF_CELL_IDS_FILE),
                    gathered(self.index.cell_ids)[:C].to(torch.int32).cpu().numpy())
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
        if isinstance(self.index, (PQIndex, IVFPQIndex)):
            self._save_pq(path)
            return
        if isinstance(self.index, StreamingExactIndex):
            ids = self.index.ids if self.index.ids is not None else range(self.index.n_docs)
            save_index(path, np.asarray(self.index.embeddings), list(ids), {"score": self.score})
            self._save_docs(path, self._doc_texts)
            return
        emb = gathered(self.index.embeddings)[: self.index.n_docs]
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

    def _save_pq(self, path: str) -> None:
        """The PQ / IVF-PQ artifact: codes (m bytes a doc), codebooks (and
        centroids, cell ids and fill counts for IVF-PQ, or the rotation for
        PQ); refine rows as int8 verbatim or bf16 as f32 (the reload re-cast
        is exact)."""
        idx = self.index
        os.makedirs(path, exist_ok=True)
        meta = {"n_docs": int(idx.n_docs), "dim": int(idx.dim), "m": int(idx.m),
                "score": self.score, "refine": idx._refine_rows is not None}
        if isinstance(idx, IVFPQIndex):
            C = int(idx.fill.shape[0])     # the real cells: a mesh's padded ones are left out
            files = {IVFPQ_CODES_FILE: gathered(idx.cell_codes)[:C],
                     IVFPQ_CELL_IDS_FILE: gathered(idx.cell_ids)[:C],
                     IVFPQ_CENTROIDS_FILE: idx.centroids, IVFPQ_CODEBOOKS_FILE: idx.codebooks,
                     IVFPQ_FILL_FILE: idx.fill}
            rows_file = IVFPQ_ROWS_FILE
            meta.update(dtype="ivfpq", bits=int(idx.bits), residual=bool(idx.residual),
                        n_probe=int(idx.default_n_probe), cell_budget=int(idx.cell_budget))
        else:
            files = {PQ_CODES_FILE: gathered(idx.codes)[: idx.n_docs], PQ_CODEBOOKS_FILE: idx.codebooks}
            if idx._rotation is not None:
                files[PQ_ROTATION_FILE] = idx._rotation
            rows_file = PQ_ROWS_FILE
            meta["dtype"] = "pq"
        for name, t in files.items():
            t = t.cpu()
            np.save(os.path.join(path, name),
                    t.numpy() if t.dtype in (torch.uint8, torch.int32) else t.float().numpy())
        if idx._refine_rows is not None:
            rows = idx._refine_rows
            np.save(os.path.join(path, rows_file),
                    rows if isinstance(rows, np.ndarray) else rows.float().numpy())
        with open(os.path.join(path, IDS_FILE), "w") as f:
            json.dump(list(idx.ids), f)
        with open(os.path.join(path, META_FILE), "w") as f:
            json.dump(meta, f)
        self._save_docs(path, self._doc_texts)

    def load(self, path: str) -> "Retriever":
        self.index, meta = load_index(
            path, mesh=self.mesh,
            dtype=None if self.index_dtype == "float32" else self.index_dtype,
            device=self.device)
        docs_path = os.path.join(path, DOCS_FILE)
        if os.path.isfile(docs_path):
            with open(docs_path) as f:
                self._doc_texts = json.load(f)
        self.score = meta.get("score", self.score)
        return self

    # ---------------- search --------------------------------------------
    def _single_dispatch(self) -> bool:
        """Whether one device call answers a batch (an updatable buffer
        changes between batches; a streamed index is a loop over tiles)."""
        return not self._is_updatable() and (
            hasattr(self.index, "_device_search_retriever")
            or hasattr(self.index, "_device_search"))

    def _default_refine(self) -> int:
        """The refine factor the index's own ``search`` applies by default:
        PQ / IVF-PQ indexes with refine rows re-rank ``DEFAULT_REFINE·k``
        candidates exactly; every other index returns 0."""
        if getattr(self.index, "_refine_rows", None) is None:
            return 0
        return int(getattr(self.index, "DEFAULT_REFINE", 0))

    def _dispatch(self, queries: List[str], k: int):
        """Encode + search without waiting for the device: → (query
        embeddings, scores, positions), the tensors still being computed
        when this returns. With a default refine the search returns
        ``DEFAULT_REFINE·k`` candidates; :meth:`_rows` re-ranks them."""
        q_emb = encode_keep_device(self.encoder.encode, queries)
        rf = self._default_refine()
        kk = min(k * rf, self.index.n_docs) if rf else k
        dev_search = getattr(self.index, "_device_search_retriever",
                             self.index._device_search)
        return (q_emb, *dev_search(q_emb, kk, self.score, 131072, "auto"))

    def _rows(self, state, k: int, return_texts: bool, pos_of) -> list:
        """Copy one batch's (scores, ids) to the host (this waits for the
        device), re-rank them exactly where the index refines by default,
        and unpack them into (doc_id, score[, text]) rows."""
        q_emb, scores, idx = state
        scores, idx = scores.cpu().numpy(), idx.cpu().numpy()
        if self._default_refine():
            # the probed pool of IVF-PQ may hold fewer than k
            scores, idx = refine_pair(q_emb, self.index._refine_rows, idx,
                                      min(k, idx.shape[1]), self.index._refine_scale,
                                      self.index.n_docs)
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
        N+1 while batch N's results copy back and re-rank. An index without
        a single-dispatch path (updatable, streaming) defers a plain
        :meth:`search` to the callable. Same rows as :meth:`search`."""
        self._require_index()
        queries = list(queries)
        if not self._single_dispatch():
            return lambda: self.search(queries, k=k, return_texts=return_texts)
        pos_of = self._pos() if (return_texts and self._doc_texts) else None
        state = self._dispatch(queries, k)
        return lambda: self._rows(state, k, return_texts, pos_of)

    def search_stream(self, query_batches, k: int = 10, depth: int = 4,
                      return_texts: bool = False):
        """Pipelined text → results loop: yields one result list per batch
        of query texts, in input order, with up to ``depth`` batches queued
        on the device (a batch's refine runs as it is taken off the
        queue)."""
        self._require_index()
        if self._is_updatable():
            raise RuntimeError(
                "search_stream needs a static index (the updatable "
                "buffer mutates between batches); use search()")
        if not self._single_dispatch():
            raise RuntimeError(
                f"{type(self.index).__name__} has no single-dispatch search "
                "(a streamed index is a loop over tiles); use search()")
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        pos_of = self._pos() if (return_texts and self._doc_texts) else None
        pending: list = []
        for queries in query_batches:
            pending.append(self._dispatch(list(queries), k))
            if len(pending) >= depth:
                yield self._rows(pending.pop(0), k, return_texts, pos_of)
        while pending:
            yield self._rows(pending.pop(0), k, return_texts, pos_of)

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
        return self._id_rows(scores, ids, return_texts and has_texts, text_of)

    def _search_ids(self, queries: List[str], k: int, return_texts: bool):
        """A static index without a single-dispatch path: its own
        ``search_ids``."""
        q_emb = encode_keep_device(self.encoder.encode, queries)
        scores, ids = self.index.search_ids(q_emb, k=k, score=self.score)
        with_texts = return_texts and bool(self._doc_texts)
        pos_of = self._pos() if with_texts else None
        return self._id_rows(scores, ids, with_texts,
                             lambda d: self._doc_texts[pos_of[d]])

    @staticmethod
    def _id_rows(scores, ids, with_texts: bool, text_of) -> list:
        out = []
        for qi in range(len(ids)):
            row = []
            for doc_id, s in zip(ids[qi], scores[qi]):
                if doc_id is None:
                    continue
                entry = (doc_id, float(s))
                if with_texts:
                    entry = (*entry, text_of(doc_id))
                row.append(entry)
            out.append(row)
        return out

    def _search_reranked(self, queries: List[str], k: int, return_texts: bool,
                         rerank_k: int):
        """The index's top ``max(k, rerank_k)`` (None ids dropped), each
        (query, doc) pair scored by the reranker, the top ``k`` by that
        score (``qst_tpu/retrieval/retriever.py:728-800``)."""
        fetch_k = max(k, rerank_k)
        if self._is_updatable():
            # the text map is taken before the search, as _search_updatable
            # takes it: a racing DELETE replaces the map, so the snapshot
            # keeps the texts of the docs the index snapshot returns
            text_of = self._texts_by_id.get
            q_emb = encode_keep_device(self.encoder.encode, queries)
            try:
                scores, ids = self.index.search(q_emb, k=fetch_k)
            except EmptyIndexError:
                return [[] for _ in queries]
            rows = self._id_rows(scores, ids, False, None)
        else:
            rows = self.search(queries, k=fetch_k)
            pos_of = self._pos()
            text_of = lambda d: self._doc_texts[pos_of[d]]  # noqa: E731
        out = []
        for query, cand in zip(queries, rows):
            # `or ""`: an add racing an updatable search can surface a doc
            # whose text is not in the snapshotted map yet — the reranker
            # gets an empty string rather than failing the batch
            texts = [text_of(i) or "" for i, _ in cand]
            ce_scores = np.asarray(self.reranker.predict([(query, t) for t in texts]))
            order = np.argsort(-ce_scores)[:k]
            cand = [(cand[int(j)][0], float(ce_scores[int(j)])) for j in order]
            out.append([(d, s, text_of(d)) if return_texts else (d, s) for d, s in cand])
        return out

    def search(self, queries: Sequence[str], k: int = 10,
               return_texts: bool = False, rerank_k: int = 0):
        """→ list per query of (doc_id, score[, text]) tuples; an IVF or
        IVF-PQ row is shorter than k when the probed cells held fewer
        documents.

        rerank_k > 0 enables two-stage retrieval: the index returns
        ``max(k, rerank_k)`` candidates, the reranker re-scores each
        (query, doc) pair, and the top ``k`` by its score are returned."""
        self._require_index()
        if rerank_k:
            has_texts = bool(self._texts_by_id if self._is_updatable() else self._doc_texts)
            if self.reranker is None:
                raise RuntimeError("rerank_k given but no reranker configured")
            if not has_texts:
                raise RuntimeError("reranking needs doc texts (build() them)")
            return self._search_reranked(list(queries), k, return_texts, rerank_k)
        if self._is_updatable():
            return self._search_updatable(list(queries), k, return_texts)
        if not self._single_dispatch():
            return self._search_ids(list(queries), k, return_texts)
        return self.search_async(queries, k=k, return_texts=return_texts)()
