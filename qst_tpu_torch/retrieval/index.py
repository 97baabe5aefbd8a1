"""Exact-kNN index — counterpart of ``qst_tpu/retrieval/index.py``.

- ``exact_topk``: the plain bucket-max scan over corpus tiles with a running
  top-k merge (``index.py:73-178``), as torch on tensors.
- ``ExactIndex``: a single-device index with float32, bfloat16 or int8
  storage and cos / dot / euclid scoring. ``search(backend=...)`` keeps the
  JAX values: ``"pallas"`` means the port's CUDA kernels (``ops/topk.py``,
  K4 + K5 via ``topk_v2``), ``"xla"`` the plain scan, and ``"auto"`` picks
  the kernels under the JAX rule (cos/dot, k ≤ 128, ≥ 65,536 docs, a
  unit-norm corpus for cos) with "the index's device is not the CPU" in
  place of "the platform is not cpu".

``mesh=`` (a ``core/meshes.py`` mesh of more than one position) splits the
corpus into 128-row-aligned shards of ``shard_rows`` rows, shard i on
``mesh.devices[i]`` (the JAX package's ``P((DATA_AXIS, MODEL_AXIS))``), and
a search is one loop over the shards: on the kernels' path each runs
``ops/topk.py:topk_local`` (K4 → selection → K5) over its block with its
host-int count of real rows, on the plain path the masked product and
``_local_topk``; the candidates merge in shard order on the mesh's first
device (``core/meshes.py:merge_topk``: ``all_gather`` + ``lax.top_k``).
``"auto"`` takes the kernels from ``PALLAS_MIN_SHARD_DOCS`` rows a shard.
The sharded plain path scores with ``SCORE_FUNCTIONS`` (f32 queries against
the stored rows), as the JAX package's sharded path does, where the
unsharded scan rounds the queries to a bf16 corpus's dtype. The int8 path quantizes each batch of queries under one scale before the
shards see it. All score functions are "larger is better" (cos / dot /
1/(1+euclid)).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from qst_tpu_torch.core.device import device_of
from qst_tpu_torch.core.meshes import (
    RowShards,
    as_mesh,
    merge_topk,
    replicate,
    shard_loop,
    shard_rows_for,
    sharded,
)
from qst_tpu_torch.ops.distances import SCORE_FUNCTIONS, l2_normalize

BUCKET = 128


def _score_fn(corpus_dtype: torch.dtype, score: str):
    """The score function of ``exact_topk`` for a corpus dtype. Operands
    upcast to f32 before each product, which is the JAX version's f32
    accumulation (exact products for bf16 and int8)."""
    if corpus_dtype == torch.int8:
        if score != "dot_score":
            raise ValueError(
                "int8 corpus needs int8 queries and score='dot_score' "
                "(ExactIndex pre-normalizes and quantizes for cos)")
        return lambda a, b: a.float() @ b.float().T
    if corpus_dtype == torch.bfloat16 and score == "cos_sim":
        def cos_bf16(a, b):
            a = l2_normalize(a.float()).to(torch.bfloat16)
            b = l2_normalize(b.float()).to(torch.bfloat16)
            return a.float() @ b.float().T
        return cos_bf16
    if corpus_dtype == torch.bfloat16 and score == "dot_score":
        return lambda a, b: a.to(torch.bfloat16).float() @ b.float().T
    return SCORE_FUNCTIONS[score]


def exact_topk(queries: torch.Tensor, corpus: torch.Tensor, k: int,
               score: str = "cos_sim", tile: int = 131072
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (scores (Q, k), indices (Q, k)) of the top-k corpus rows per query.

    Exact two-level scan: each tile's scores reduce to per-128-bucket
    maxima, the scan merges the top-k buckets per query while carrying each
    candidate bucket's 128 scores, and one narrow top-k over (Q, k·128)
    resolves element ranks."""
    if corpus.dtype == torch.int8 and queries.dtype != torch.int8:
        raise ValueError("int8 corpus needs int8 queries and score='dot_score'")
    score_fn = _score_fn(corpus.dtype, score)
    n = corpus.shape[0]
    k = min(k, n)
    if n <= max(4096, 4 * k * BUCKET):
        return torch.topk(score_fn(queries, corpus), k, dim=1)

    tile = min(tile, -(-n // BUCKET) * BUCKET)
    Q = queries.shape[0]
    dev = corpus.device
    best_m = torch.full((Q, k), float("-inf"), device=dev)
    best_b = torch.full((Q, k), -1, dtype=torch.int64, device=dev)
    best_rows = torch.full((Q, k, BUCKET), float("-inf"), device=dev)
    for t0 in range(0, n, tile):
        s = score_fn(queries, corpus[t0:t0 + tile])            # (Q, ≤ tile)
        if s.shape[1] < tile:                                  # mask padded rows
            s = torch.nn.functional.pad(s, (0, tile - s.shape[1]), value=float("-inf"))
        rows = s.reshape(Q, tile // BUCKET, BUCKET)
        m1, b1 = torch.topk(rows.amax(dim=2), k, dim=1)        # narrow top-k
        rows1 = torch.gather(rows, 1, b1[:, :, None].expand(Q, k, BUCKET))
        cat_m = torch.cat([best_m, m1], dim=1)                 # (Q, 2k)
        cat_b = torch.cat([best_b, b1 + t0 // BUCKET], dim=1)
        cat_rows = torch.cat([best_rows, rows1], dim=1)
        best_m, pos = torch.topk(cat_m, k, dim=1)
        best_b = torch.gather(cat_b, 1, pos)
        best_rows = torch.gather(cat_rows, 1, pos[:, :, None].expand(Q, k, BUCKET))
    top_s, flat_pos = torch.topk(best_rows.reshape(Q, k * BUCKET), k, dim=1)
    bucket_id = torch.gather(best_b, 1, flat_pos // BUCKET)
    return top_s, bucket_id * BUCKET + flat_pos % BUCKET


def _local_topk(s: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over a (Q, W) score block. For wide W, go through
    128-bucket maxima: the top-k bucket maxima cover the top-k elements, so
    no wide top-k runs."""
    Q, W = s.shape
    if W <= max(4096, 4 * k * BUCKET) or W % BUCKET != 0:
        return torch.topk(s, k, dim=1)
    rows = s.reshape(Q, W // BUCKET, BUCKET)
    # which buckets, in any order: the last top-k sorts (one launch fewer)
    b_idx = torch.topk(rows.amax(dim=2), k, dim=1, sorted=False).indices   # (Q, k) buckets
    cand = torch.gather(rows, 1, b_idx[:, :, None].expand(Q, k, BUCKET))
    top_s, pos = torch.topk(cand.reshape(Q, k * BUCKET), k, dim=1)
    bucket = torch.gather(b_idx, 1, pos // BUCKET)
    return top_s, bucket * BUCKET + pos % BUCKET


def _plain_local(score_fn, k: int):
    """A shard's plain search: the product over its block, rows at or past
    its real count masked to −inf, then ``_local_topk``."""
    def local(q: torch.Tensor, block: torch.Tensor, n_local: int):
        s = score_fn(q, block)
        col = torch.arange(block.shape[0], device=s.device)
        s = torch.where(col[None, :] < n_local, s, float("-inf"))
        return _local_topk(s, min(k, block.shape[0]))
    return local


class ExactIndex:
    """Exact index over an embedding matrix, on one device or sharded over a
    mesh. Use :meth:`search` for top-k ids + scores."""

    PALLAS_MIN_DOCS = 65536        # below this the plain scan is used
    PALLAS_MIN_SHARD_DOCS = 16384  # the per-shard threshold

    def __init__(self, embeddings: Any, ids: Optional[list] = None,
                 mesh: Any = None, normalize: bool = False,
                 dtype: str = "float32", int8_scale: Optional[float] = None,
                 cache_cos_corpus: bool = False, device: Any = None):
        """embeddings: (N, D) tensor or array; the index lives on ``device``
        (default: a tensor's own device; host arrays go to the GPU).

        dtype="bfloat16" stores the corpus in bf16 (ranking exact w.r.t.
        bf16-input scores); dtype="int8" stores a unit-normalized,
        symmetrically quantized corpus (integer-exact scoring, cos/dot
        only). ``int8_scale`` with an int8 array adopts a pre-quantized
        corpus verbatim (the reload path). ``cache_cos_corpus=True`` keeps a
        unit-norm copy for cos searches through the kernels on a
        non-normalized index."""
        mesh = as_mesh(mesh)
        if mesh is not None and device is None:
            device = mesh.home
        self.device = device_of(embeddings, device)
        pre_quantized = (dtype == "int8" and int8_scale is not None
                         and str(getattr(embeddings, "dtype", "")).endswith("int8"))
        if pre_quantized:
            emb = torch.as_tensor(embeddings, device=self.device)
        else:
            if int8_scale is not None:
                raise ValueError(
                    "int8_scale is only for adopting an already-quantized "
                    "int8 array with dtype='int8'")
            emb = torch.as_tensor(embeddings, device=self.device).float()
        if emb.ndim != 2 or emb.shape[0] == 0:
            raise ValueError(f"embeddings must be (N, D), got {tuple(emb.shape)}")
        if normalize and pre_quantized:
            raise ValueError("pre-quantized int8 rows are already "
                             "unit-normalized; drop normalize=True")
        if normalize:
            emb = l2_normalize(emb)
        if dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(f"dtype must be float32|bfloat16|int8, got {dtype}")
        self._int8_scale = None
        if dtype == "int8" and emb.shape[1] * 127 * 127 >= 1 << 24:
            raise ValueError(
                f"dim {emb.shape[1]} too wide for int8 storage "
                "(D·127² must stay below 2^24 for exact f32 sums)")
        if pre_quantized:
            self._int8_scale = float(int8_scale)
            self._normalized = True
        elif dtype == "int8":
            emb = l2_normalize(emb)
            self._normalized = True
            scale = 127.0 / torch.clamp(emb.abs().max(), min=1e-12)
            self._int8_scale = float(scale)
            emb = torch.clamp(torch.round(emb * self._int8_scale), -127, 127).to(torch.int8)
        else:
            emb = emb.to(getattr(torch, dtype))
            self._normalized = normalize
        self.n_docs, self.dim = emb.shape
        self.ids = list(ids) if ids is not None else list(range(self.n_docs))
        if len(self.ids) != self.n_docs:
            raise ValueError("ids length mismatch")
        self.mesh = sharded(mesh)
        self._dtype = emb.dtype
        if self.mesh is not None:
            # 128-row-aligned shards: topk_local takes whole buckets
            self.shard_rows = shard_rows_for(self.n_docs, self.mesh.size, BUCKET)
            emb = torch.nn.functional.pad(
                emb, (0, 0, 0, self.shard_rows * self.mesh.size - self.n_docs))
            # the padded rows, split: readers take .blocks or .gather()
            self.embeddings = RowShards(emb.contiguous(), self.mesh, self.shard_rows)
            self.device = self.mesh.home
        else:
            self.embeddings = emb.contiguous()
        self._cache_cos_corpus = bool(cache_cos_corpus)
        self._cos_corpus = None   # a unit-norm copy (a list of blocks with a mesh)

    def _pallas_eligible(self, k: int, score: str) -> bool:
        needs_copy = (score == "cos_sim" and not self._normalized
                      and not self._cache_cos_corpus)
        big_enough = (self.n_docs >= self.PALLAS_MIN_DOCS if self.mesh is None
                      else self.shard_rows >= self.PALLAS_MIN_SHARD_DOCS)
        return (k <= 128
                and score in ("cos_sim", "dot_score")
                and not needs_copy
                and big_enough
                and self.device.type != "cpu")

    def search(self, queries, k: int = 10, score: str = "cos_sim",
               tile: int = 131072, backend: str = "auto"
               ) -> Tuple[np.ndarray, np.ndarray]:
        """→ (scores (Q, k), indices (Q, k)) as numpy. k is clamped to N.

        backend: "auto" uses the CUDA kernels (K4 + K5) for cos/dot
        searches over large corpora on a GPU, else the plain scan;
        "pallas" / "xla" force one (on a CPU index "pallas" runs the
        kernels' plain versions)."""
        s, i = self._device_search(queries, k, score, tile, backend)
        return s.cpu().numpy(), i.cpu().numpy()

    def _queries(self, queries) -> torch.Tensor:
        return torch.as_tensor(queries, device=self.device).float()

    def _device_search(self, queries, k: int, score: str, tile: int,
                       backend: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """Dispatch one search; returns device tensors (not synchronized)."""
        if score not in SCORE_FUNCTIONS:
            raise ValueError(
                f"unknown score {score!r}; choices: {sorted(SCORE_FUNCTIONS)}")
        if backend not in ("auto", "pallas", "xla"):
            raise ValueError(f"unknown backend {backend!r}")
        k = min(k, self.n_docs)
        use_kernels = (backend == "pallas"
                       or (backend == "auto" and self._pallas_eligible(k, score)))
        if self._dtype == torch.int8:
            return self._device_search_int8(queries, k, score, tile, use_kernels)
        q = self._queries(queries)
        if not use_kernels:
            if self.mesh is not None:
                return self._sharded_search(q, k, self.embeddings.blocks,
                                            _plain_local(SCORE_FUNCTIONS[score], k))
            return exact_topk(q, self.embeddings, k, score, tile)
        if score not in ("cos_sim", "dot_score"):
            raise ValueError("pallas backend supports cos/dot scores")
        from qst_tpu_torch.ops.topk import topk_local, topk_v2

        cc = self.embeddings if self.mesh is None else self.embeddings.blocks
        if score == "cos_sim":
            q = l2_normalize(q)
            if not self._normalized:
                # the kernels score raw dots, so cos needs a unit-norm corpus:
                # cached with cache_cos_corpus=True, else made for this call
                if self._cos_corpus is not None:
                    cc = self._cos_corpus
                else:
                    unit = lambda c: l2_normalize(c.float()).to(c.dtype)  # noqa: E731
                    cc = (unit(cc) if self.mesh is None
                          else [None if c is None else unit(c) for c in cc])
                    if self._cache_cos_corpus:
                        self._cos_corpus = cc
        q = q.to(self._dtype)
        if self.mesh is not None:
            return self._sharded_search(q, k, cc, lambda qd, c, n: topk_local(qd, c, k, n))
        return topk_v2(q, cc, k)

    def _sharded_search(self, q: torch.Tensor, k: int, blocks, local
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The shard loop: ``local(queries, block, n_local)`` → (scores, local
        row ids) on each shard, offset by the shard's first row, merged in
        shard order on the index's device. Every offset and count is a host
        int: no shard waits for another."""
        qs = replicate(q, self.mesh)

        def shard(i: int, dev) -> Tuple[torch.Tensor, torch.Tensor]:
            base = i * self.shard_rows
            s, idx = local(qs[dev], blocks[i],
                           max(0, min(self.n_docs - base, self.shard_rows)))
            return s, idx + base

        return merge_topk(shard_loop(self.mesh, shard), k, self.device)

    def _device_search_int8(self, queries, k: int, score: str, tile: int,
                            use_kernels: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """normalize (cos) → quantize the queries under a per-call symmetric
        scale → integer-exact scoring (kernels or plain scan) → descale back
        to the cosine domain."""
        if score not in ("cos_sim", "dot_score"):
            raise ValueError(
                "int8 index supports cos_sim/dot_score only (magnitudes "
                "are normalized away at quantization)")
        qf = self._queries(queries)
        if score == "cos_sim":
            qf = l2_normalize(qf)
        qscale = 127.0 / torch.clamp(qf.abs().max(), min=1e-12)
        qi = torch.clamp(torch.round(qf * qscale), -127, 127).to(torch.int8)
        if self.mesh is not None:
            from qst_tpu_torch.ops.topk import topk_local

            local = ((lambda qd, c, n: topk_local(qd, c, k, n)) if use_kernels
                     else _plain_local(_score_fn(torch.int8, "dot_score"), k))
            s, i = self._sharded_search(qi, k, self.embeddings.blocks, local)
        elif use_kernels:
            from qst_tpu_torch.ops.topk import topk_v2

            s, i = topk_v2(qi, self.embeddings, k)
        else:
            s, i = exact_topk(qi, self.embeddings, k, "dot_score", tile)
        return s / (qscale * self._int8_scale), i

    def search_stream(self, query_batches, k: int = 10,
                      score: str = "cos_sim", tile: int = 131072,
                      backend: str = "auto", depth: int = 4):
        """Pipelined serving loop: yields ``(scores, indices)`` numpy pairs,
        one per query batch in input order, keeping up to ``depth`` searches
        queued on the device before copying the oldest result back."""
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        pending: list = []
        for q in query_batches:
            pending.append(self._device_search(q, k, score, tile, backend))
            if len(pending) >= depth:
                s, i = pending.pop(0)
                yield s.cpu().numpy(), i.cpu().numpy()
        while pending:
            s, i = pending.pop(0)
            yield s.cpu().numpy(), i.cpu().numpy()

    def search_ids(self, queries, k: int = 10, score: str = "cos_sim"):
        """→ (scores, doc-id lists) using the external ids."""
        s, i = self.search(queries, k, score)
        return s, [[self.ids[j] for j in row] for row in i]
