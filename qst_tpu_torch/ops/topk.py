"""K4 and K5: exact top-k search over a device-resident corpus — counterpart
of ``qst_tpu/ops/topk_pallas.py``.

The pipeline (``topk_v2``, counterpart of ``pallas_topk_v2``, ``:385``):

1. ``bucket_maxima`` (K4) — fused score product + 128-bucket maximum; the
   (Q, N) scores never reach device memory, only the (Q, N/128) maxima do.
   Replaces ``_bucket_max_kernel`` (``topk_pallas.py:92``).
2. ``_hierarchical_top_buckets`` — winning-bucket selection without a wide
   top-k (plain torch, as it is plain XLA on the TPU).
3. ``rescore_buckets`` (K5) — each query's k winning buckets gathered by id
   and scored exactly. Replaces ``_rescore_kernel`` (``topk_pallas.py:251``).
4. one narrow top-k over (Q, k·128).

``topk_local`` (counterpart of ``pallas_topk_local``, ``:346``) runs the same
pipeline over a corpus slice with a valid-row count: K4 takes it as
``n_real``, bucket ids that the selection draws from the −inf padding (a
slice with fewer than k finite buckets) are clamped and dropped, and rows at
or past the count are masked after K5, which scores the padding as finite.
The PQ index's kernels' path and the streamed index run it a slice or tile
at a time.

Exactness: if e is one of the top-k elements, at most k−1 buckets can have a
maximum above e's bucket maximum, so the top-k buckets contain the top-k
elements.

The kernels are CUDA C++ in ``kernels/csrc/topk.cu``; its header says what
bounds each on the H100 and gives the designs in full. In short:

- K4 is bound by its 2·Q·N·D operations once Q is in the thousands (3.3 ms
  at Q = 4096 over 1M × 384 bf16) and by the N·D corpus bytes at the serving
  shapes (Q ≤ 256: 0.24 ms). bf16 and int8 (D % 16 == 0) run a persistent
  TMA + ``wgmma`` kernel: a block keeps its 128-query tile in shared memory,
  corpus buckets stream through a ring, the blocks of a group walk the same
  buckets in step (a bucket comes from device memory about once), and the
  bucket maximum is taken from the accumulator registers. f32 runs on the
  FMA units (exact f32 products).
- K5 is bound by reading each distinct winning bucket once. The wrapper
  sorts the (query, slot) pairs by bucket id (``_group_pairs_by_bucket``:
  index glue, like the bucket selection) and a block brings a bucket into
  shared memory once for the run of pairs that chose it. Below
  ``_GROUP_MIN_PAIRS`` pairs (Q·k; the server's largest batch, 256 queries
  of k = 10, is under it) few buckets are shared and the sort is one more
  launch on a host-bound path, so every pair gets its own block in the order
  it came: on the H100 the two forms cross between 5,120 and 10,240 pairs
  over corpora of 512 to 8,192 buckets (``chip_smoke.py``'s ``times``).

Each wrapper takes its plain version only for CPU tensors; CUDA tensors
launch the kernel or raise. ``bucket_maxima.launches`` and
``rescore_buckets.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

BUCKET = 128
_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.int8)


def reference_topk(queries: torch.Tensor, corpus: torch.Tensor,
                   k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain full-product top-k, for golden tests."""
    return torch.topk(queries.float() @ corpus.float().T, k, dim=1)


def _compute_dtype(queries: torch.Tensor, corpus: torch.Tensor) -> torch.dtype:
    """The dtype both operands are scored in (as ``bucket_maxima`` on the
    TPU): int8 needs int8 queries; bf16 corpora score in bf16; else f32."""
    if corpus.dtype == torch.int8:
        if queries.dtype != torch.int8:
            raise ValueError(
                "int8 corpus needs int8 queries (quantize them with the same "
                "symmetric scheme — ExactIndex does this)")
        if queries.shape[1] * 127 * 127 >= 1 << 24:
            raise ValueError(
                f"D={queries.shape[1]} too wide for the exact int8 path "
                "(D·127² must stay below 2^24)")
        return torch.int8
    return torch.bfloat16 if corpus.dtype == torch.bfloat16 else torch.float32


def _check_dims(queries: torch.Tensor, corpus: torch.Tensor) -> None:
    if queries.ndim != 2 or corpus.ndim != 2 or queries.shape[1] != corpus.shape[1]:
        raise ValueError(
            f"queries (Q, D) and corpus (N, D) must share D, got "
            f"{tuple(queries.shape)} and {tuple(corpus.shape)}")


def _cuda_operands(queries: torch.Tensor, corpus: torch.Tensor, what: str):
    """Validate CUDA operands and cast the queries to the compute dtype."""
    dt = _compute_dtype(queries, corpus)
    if queries.device.type != "cuda" or corpus.device != queries.device:
        raise ValueError(f"{what}: queries and corpus must be on one CUDA device, "
                         f"got {queries.device} and {corpus.device}")
    if corpus.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{what}: kernel takes float32/bfloat16/int8, got {corpus.dtype}")
    queries = queries.to(dt).contiguous()
    if not corpus.is_contiguous() or corpus.data_ptr() % 16 or queries.data_ptr() % 16:
        raise ValueError(f"{what}: operands must be contiguous and 16-byte aligned")
    return queries, corpus


def bucket_maxima_plain(queries: torch.Tensor, corpus: torch.Tensor,
                        n_real: Optional[int] = None) -> torch.Tensor:
    """Plain version of K4: (Q, ceil(N/128)) f32 bucket maxima, rows at or
    past ``n_real`` scoring −inf. Operands upcast to f32 before the product
    (exact products, f32 sums — and exact integers for int8)."""
    _check_dims(queries, corpus)
    dt = _compute_dtype(queries, corpus)
    N = corpus.shape[0]
    n_real = N if n_real is None else int(n_real)
    s = queries.to(dt).float() @ corpus.float().T
    n_buckets = -(-N // BUCKET)
    col = torch.arange(n_buckets * BUCKET, device=s.device)
    s = torch.nn.functional.pad(s, (0, n_buckets * BUCKET - N))
    s = torch.where(col[None, :] < n_real, s, float("-inf"))
    return s.reshape(-1, n_buckets, BUCKET).amax(dim=2)


_BM_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                + [ctypes.c_void_p])


def bucket_maxima(queries: torch.Tensor, corpus: torch.Tensor,
                  n_real: Optional[int] = None) -> torch.Tensor:
    """Fused scores → 128-bucket maxima, (Q, ceil(N/128)) f32.

    ``n_real`` masks rows at or past it to −inf (default: all N rows); the
    width stays ceil(N/128). Queries are scored in the corpus's compute
    dtype (bf16 for a bf16 corpus, int8 for int8, else f32)."""
    _check_dims(queries, corpus)
    if queries.device.type == "cpu" and corpus.device.type == "cpu":
        return bucket_maxima_plain(queries, corpus, n_real)
    q, c = _cuda_operands(queries, corpus, "bucket_maxima")
    from qst_tpu_torch.kernels import build

    Q, D = q.shape
    N = c.shape[0]
    if D % (4 if c.dtype == torch.int8 else 8 if c.dtype == torch.bfloat16 else 1):
        raise ValueError(f"bucket_maxima kernel needs D % 8 == 0 (bf16) / % 4 (int8), got {D}")
    n_real = N if n_real is None else int(n_real)
    out = torch.empty((Q, -(-N // BUCKET)), dtype=torch.float32, device=q.device)
    fn = build.function("qst_bucket_maxima", _BM_ARGTYPES)
    with torch.cuda.device(q.device):   # launch into the tensors' device context
        code = fn(build.DTYPE_CODES[str(c.dtype).removeprefix("torch.")], q.data_ptr(),
                  c.data_ptr(), out.data_ptr(), Q, N, D, n_real,
                  torch.cuda.current_stream(q.device).cuda_stream)
    build.count_launch(bucket_maxima)
    build.check(code, "bucket_maxima")
    return out


bucket_maxima.launches = 0


def _hierarchical_top_buckets(bm: torch.Tensor, k: int) -> torch.Tensor:
    """→ (Q, k) winning bucket ids from (Q, NB) bucket maxima without a wide
    top-k: super-bucket maxima → narrow top-k → gather → narrow top-k."""
    Q, NB = bm.shape
    nb_pad = -(-NB // BUCKET) * BUCKET
    if nb_pad != NB:
        bm = torch.nn.functional.pad(bm, (0, nb_pad - NB), value=float("-inf"))
    n_super = nb_pad // BUCKET
    tiles = bm.reshape(Q, n_super, BUCKET)
    smax = tiles.amax(dim=2)                                   # (Q, n_super)
    kk = min(k, n_super)
    s_idx = torch.topk(smax, kk, dim=1).indices                # (Q, kk)
    cand = torch.gather(tiles, 1, s_idx[:, :, None].expand(Q, kk, BUCKET))
    pos = torch.topk(cand.reshape(Q, kk * BUCKET), k, dim=1).indices
    super_id = torch.gather(s_idx, 1, pos // BUCKET)
    return super_id * BUCKET + pos % BUCKET                    # (Q, k)


_PLAIN_QUERY_CHUNK = 256   # queries per gather in rescore_buckets_plain


def rescore_buckets_plain(queries: torch.Tensor, corpus: torch.Tensor,
                          bucket_ids: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version of K5: (Q, k·128) f32 exact scores of each query against
    its k buckets; rows at or past N score −inf. Chunked over queries so the
    gathered rows stay small."""
    _check_dims(queries, corpus)
    dt = _compute_dtype(queries, corpus)
    Q = queries.shape[0]
    N = corpus.shape[0]
    rows = (bucket_ids.long()[:, :, None] * BUCKET
            + torch.arange(BUCKET, device=bucket_ids.device)).reshape(Q, k * BUCKET)
    valid = (rows >= 0) & (rows < N)
    out = torch.empty((Q, k * BUCKET), dtype=torch.float32, device=queries.device)
    q = queries.to(dt).float()
    for lo in range(0, Q, _PLAIN_QUERY_CHUNK):
        hi = lo + _PLAIN_QUERY_CHUNK
        docs = corpus[rows[lo:hi].clamp(0, N - 1)].float()     # (q, k·128, D)
        out[lo:hi] = torch.einsum("qd,qnd->qn", q[lo:hi], docs)
    return torch.where(valid, out, float("-inf"))


_RS_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                + [ctypes.c_void_p])
# K5 groups its pairs by bucket from this many (query, slot) pairs on
_GROUP_MIN_PAIRS = 8192
_MAX_PAIRS_PER_BLOCK = 32     # splits a popular bucket; a cut run is fetched twice
_RESCORE_MAX_ROW_BYTES = 28 * 1024   # eight padded rows must fit a block's shared memory


def _group_pairs_by_bucket(bucket_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, k) bucket ids → (ids (Q·k,) in ascending order, order (Q·k,)
    int64): position p of the sorted ids belongs to pair ``order[p]`` =
    q·k + slot. Every pair appears once; pairs of one bucket are neighbours."""
    return torch.sort(bucket_ids.reshape(-1))


def rescore_buckets(queries: torch.Tensor, corpus: torch.Tensor,
                    bucket_ids: torch.Tensor, k: int) -> torch.Tensor:
    """→ (Q, k·BUCKET) exact scores of each query against its k winning
    buckets (``bucket_ids`` (Q, k)); rows at or past N are −inf. Unlike the
    TPU version the corpus is not padded to a bucket multiple."""
    _check_dims(queries, corpus)
    if bucket_ids.shape != (queries.shape[0], k):
        raise ValueError(f"bucket_ids must be (Q, k) = ({queries.shape[0]}, {k}), "
                         f"got {tuple(bucket_ids.shape)}")
    if (queries.device.type == "cpu" and corpus.device.type == "cpu"
            and bucket_ids.device.type == "cpu"):
        return rescore_buckets_plain(queries, corpus, bucket_ids, k)
    q, c = _cuda_operands(queries, corpus, "rescore_buckets")
    if bucket_ids.device != q.device:
        raise ValueError("bucket_ids must be on the queries' device")
    from qst_tpu_torch.kernels import build

    Q, D = q.shape
    row_bytes = D * c.element_size()
    if row_bytes % 16 or row_bytes > _RESCORE_MAX_ROW_BYTES:
        raise ValueError(f"rescore kernel needs D·itemsize % 16 == 0 and <= "
                         f"{_RESCORE_MAX_ROW_BYTES} bytes, got D={D}")
    ids = bucket_ids.to(torch.int32).contiguous()
    n_pairs = Q * k
    if n_pairs >= _GROUP_MIN_PAIRS:
        ids, order = _group_pairs_by_bucket(ids)
        order_ptr = order.data_ptr()
        # blocks enough for a few waves over the SMs, runs long enough to share
        pairs_per_block = max(1, min(_MAX_PAIRS_PER_BLOCK, n_pairs // 512))
    else:
        order_ptr, pairs_per_block = None, 1
    out = torch.empty((Q, k * BUCKET), dtype=torch.float32, device=q.device)
    fn = build.function("qst_rescore_buckets", _RS_ARGTYPES)
    with torch.cuda.device(q.device):
        code = fn(build.DTYPE_CODES[str(c.dtype).removeprefix("torch.")], q.data_ptr(),
                  c.data_ptr(), ids.data_ptr(), order_ptr, out.data_ptr(), Q, c.shape[0], D,
                  k, pairs_per_block, torch.cuda.current_stream(q.device).cuda_stream)
    build.count_launch(rescore_buckets)
    build.check(code, "rescore_buckets")
    return out


rescore_buckets.launches = 0


def topk_v2(queries: torch.Tensor, corpus: torch.Tensor,
            k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k: bucket maxima (K4) → hierarchical bucket selection →
    winning-bucket rescore (K5) → final narrow top-k. Any k ≤ 128.
    → (scores (Q, k) f32, ids (Q, k) int64)."""
    N = corpus.shape[0]
    k = min(k, N)
    if k > BUCKET:
        raise ValueError(f"topk_v2 supports k <= {BUCKET}, got {k}")
    bm = bucket_maxima(queries, corpus)
    bucket_ids = _hierarchical_top_buckets(bm, k)              # (Q, k)
    scores = rescore_buckets(queries, corpus, bucket_ids, k)   # (Q, k·128)
    Q = scores.shape[0]
    doc_ids = (bucket_ids[:, :, None] * BUCKET
               + torch.arange(BUCKET, device=bucket_ids.device)).reshape(Q, k * BUCKET)
    top_s, pos = torch.topk(scores, k, dim=1)
    return top_s, torch.gather(doc_ids, 1, pos)


def _topk_local(queries: torch.Tensor, corpus: torch.Tensor, k: int, n_local: int,
                maxima, rescore) -> Tuple[torch.Tensor, torch.Tensor]:
    """The body of ``topk_local`` over given K4 / K5 functions (the kernels'
    wrappers or their plain versions)."""
    rows = corpus.shape[0]
    if rows % BUCKET:
        raise ValueError(f"corpus rows {rows} not a multiple of {BUCKET}")
    if k > BUCKET:
        raise ValueError(f"topk_local supports k <= {BUCKET}, got {k}")
    n_local = max(0, min(int(n_local), rows))
    bm = maxima(queries, corpus, n_local)                      # (Q, NB)
    NB = bm.shape[1]
    ids_raw = _hierarchical_top_buckets(bm, k)                 # (Q, k)
    # fewer than k finite buckets: the selection can return ids in the −inf
    # padding past NB — clamp them for the rescore and mask them after
    valid = ids_raw < NB
    bucket_ids = ids_raw.clamp_max(NB - 1)
    scores = rescore(queries, corpus, bucket_ids, k)           # (Q, k·128)
    Q = scores.shape[0]
    doc_ids = (bucket_ids[:, :, None] * BUCKET
               + torch.arange(BUCKET, device=bucket_ids.device))      # (Q, k, 128)
    # rows at or past n_local are padding that K5 scores as finite
    ok = (valid[:, :, None] & (doc_ids < n_local)).reshape(Q, k * BUCKET)
    scores = torch.where(ok, scores, float("-inf"))
    top_s, pos = torch.topk(scores, k, dim=1)
    return top_s, torch.gather(doc_ids.reshape(Q, k * BUCKET), 1, pos)


def topk_local(queries: torch.Tensor, corpus: torch.Tensor, k: int,
               n_local: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over the first ``n_local`` rows of a corpus slice whose
    row count is a multiple of 128 — counterpart of ``pallas_topk_local``
    (``topk_pallas.py:346``): K4 with ``n_real = n_local`` → bucket
    selection → K5 → one narrow top-k. Slots past the real rows carry −inf
    (their ids are arbitrary), so a caller's merge across slices drops them.
    → (scores (Q, k) f32, local row ids (Q, k) int64). k ≤ 128."""
    return _topk_local(queries, corpus, k, n_local, bucket_maxima, rescore_buckets)


def topk_local_plain(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                     n_local: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``topk_local``: the plain K4 and K5 under the same
    masks, on any device."""
    return _topk_local(queries, corpus, k, n_local, bucket_maxima_plain,
                       rescore_buckets_plain)
