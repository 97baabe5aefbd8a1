"""Product-quantization (PQ) index — counterpart of ``qst_tpu/retrieval/pq.py``.

Each document is stored as ``m`` one-byte codes (one per D/m-dim subspace,
256 centroids each): 48 bytes a doc at the default m = 48, 16× less than
bf16 rows. Scores are approximate; ``keep_rows`` keeps the unit-normalized
originals in host memory for an exact re-rank of ``k·refine_factor``
candidates.

- **Training**: ``m`` independent 256-way Lloyd k-means (``pq_lloyd``),
  optionally score-aware (``anisotropic=eta``: the assignment minimizes
  ‖v−c‖² + eta·(vᵀ(v−c))², the update is a per-cluster weighted least
  squares). The initial centroids, the training sample and the optional
  random rotation are drawn from a ``torch.Generator`` (the JAX package
  draws them with ``jax.random``, which has no torch twin): a built index
  is statistically, not bitwise, the JAX one; ``from_codes`` carries a
  JAX-built index across exactly, and ``pq_lloyd`` takes given initial
  codebooks.
- **Encoding**: one batched product + argmax per chunk.
- **Search** decodes codes to reconstructions, then scores them exactly
  against the (unquantized) queries. Two backends, named as in the JAX
  package: ``"xla"`` (``pq_topk``) scans ``PQ_SCORE_TILE``-row tiles with a
  plain product and a running top-k; ``"pallas"`` decodes
  ``PQ_SUPER_TILE``-row slices and runs K4 → bucket selection → K5
  (``ops/topk.py:topk_local``) over each, so the (Q, rows) scores never
  reach device memory, and merges the slices' winners. ``"auto"`` takes the
  kernels under the JAX rule (k ≤ 128, ≥ 65,536 docs, ≥ 256 queries) with
  "the index's device is not the CPU" for "the platform is not cpu".
- **Decode**: the JAX package expands codes through a one-hot product
  (``_decode_onehot``) because a TPU dislikes gathers. A one-hot row picks
  exactly one codebook entry, so the gather (``_decode_gather``) gives the
  same bits; it is the default here and the one the card runs.
  ``decode="onehot"`` stays selectable.
- **Compute dtype** follows the device: f32 on the CPU (as the JAX package
  on its CPU backend), bf16 on a GPU — decoded rows and queries in bf16,
  products summed in f32.
- **Refine** (``refine_pair``): the candidates' rows are gathered from the
  host table and re-scored on the host (numpy, ``REFINE_ON_HOST``) or on
  the device. numpy has no bfloat16: bf16 refine rows are a CPU
  ``torch.bfloat16`` tensor; int8 rows (fixed scale 127) a numpy array.

- **A mesh** (``mesh=``, ``core/meshes.py``) splits the code matrix into
  ``shard_rows``-row shards (a multiple of ``pq_pad_quantum``); each shard
  runs the scan or the kernels' slices over its block with its host-int
  count of real rows, and the candidates merge in shard order
  (``core/meshes.py:merge_topk``); the refine stays on the host.

Scores follow the int8 index's contract: rows are unit-normalized at encode
time, so cos ≡ dot.
"""

from __future__ import annotations

import itertools
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from qst_tpu_torch.core.device import device_of
from qst_tpu_torch.core.meshes import (
    RowShards,
    as_mesh,
    merge_topk,
    replicate,
    shard_loop,
    sharded,
)
from qst_tpu_torch.ops.distances import l2_normalize
from qst_tpu_torch.ops.topk import topk_local
from qst_tpu_torch.retrieval.index import _local_topk
from qst_tpu_torch.retrieval.ivf import _tensor, row_reader, sample_rows

K_CENTROIDS = 256  # one byte per code


def random_rotation(d: int, seed: int = 0) -> torch.Tensor:
    """Random orthogonal (d, d) f32 matrix on the CPU (QR of a Gaussian
    drawn from ``seed``, signs fixed so the draw decides it): rotating
    before the subspace split spreads variance evenly across subspaces."""
    g = torch.randn((d, d), generator=torch.Generator().manual_seed(seed))
    q, r = torch.linalg.qr(g)
    return q * torch.sign(torch.diagonal(r))[None, :]


def _aniso_fit(xs: torch.Tensor, cb: torch.Tensor, eta: float) -> torch.Tensor:
    """Negated per-(point, centroid) assignment loss, batched over
    subspaces: xs (m, S, ds), cb (m, K, ds) → (m, S, K). The classic
    −½‖v−c‖² (up to a per-point constant) plus, for eta > 0, the
    score-aware −½·eta·(vᵀ(v−c))²."""
    dots = torch.einsum("msd,mkd->msk", xs, cb)               # v·c
    fit = dots - 0.5 * torch.sum(cb * cb, dim=-1)[:, None, :]
    if eta > 0.0:
        vv = torch.sum(xs * xs, dim=-1)[:, :, None]           # ‖v‖²
        fit = fit - 0.5 * eta * (vv - dots) ** 2
    return fit


_LLOYD_CHUNK = 16384   # points a Lloyd step scores at once: bounds the (m, chunk, K) fit


def pq_lloyd(xs: torch.Tensor, cb: torch.Tensor, n_iters: int,
             eta: float = 0.0) -> torch.Tensor:
    """The Lloyd loop of per-subspace k-means from given initial codebooks:
    xs (m, S, ds) f32, cb (m, K, ds) → (m, K, ds) f32. Empty clusters keep
    their centroid. ``eta > 0`` updates each cluster by the weighted least
    squares [n I + eta Σ v vᵀ] c = Σ v (1 + eta ‖v‖²) (regularized 1e-6)."""
    m, S, ds = xs.shape
    K = cb.shape[1]
    cb = cb.float()
    eye = torch.eye(ds, device=xs.device)
    for _ in range(n_iters):
        sums = torch.zeros((m, K, ds), device=xs.device)
        counts = torch.zeros((m, K), device=xs.device)
        if eta:
            A = torch.zeros((m, K, ds, ds), device=xs.device)
            b_eta = torch.zeros((m, K, ds), device=xs.device)
        for lo in range(0, S, _LLOYD_CHUNK):
            x = xs[:, lo:lo + _LLOYD_CHUNK]
            onehot = torch.nn.functional.one_hot(
                torch.argmax(_aniso_fit(x, cb, eta), dim=-1), K).float()   # (m, s, K)
            sums += torch.einsum("msk,msd->mkd", onehot, x)
            counts += onehot.sum(dim=1)
            if eta:
                A += torch.einsum("msk,msd,mse->mkde", onehot, x, x)
                b_eta += torch.einsum("msk,ms,msd->mkd", onehot, torch.sum(x * x, dim=-1), x)
        if eta:
            A = A * eta + counts[:, :, None, None] * eye + 1e-6 * eye
            new = torch.linalg.solve(A, (sums + eta * b_eta)[..., None])[..., 0]
        else:
            new = sums / counts.clamp_min(1)[:, :, None]
        cb = torch.where(counts[:, :, None] > 0, new, cb)
    return cb


def pq_train(sample: torch.Tensor, generator: torch.Generator, m: int,
             n_iters: int = 12, eta: float = 0.0,
             init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Train per-subspace codebooks on a sample (unit-normalized here) →
    (m, 256, ds) f32. The initial centroids are 256 distinct sample rows
    drawn with ``generator`` (a CPU generator) unless ``init`` gives them."""
    s, d = sample.shape
    x = l2_normalize(sample.float())
    xs = x.reshape(s, m, d // m).transpose(0, 1)              # (m, S, ds)
    if init is None:
        idx = torch.randperm(s, generator=generator)[:K_CENTROIDS].to(xs.device)
        init = xs[:, idx, :]
    return pq_lloyd(xs, init, n_iters, eta)


def pq_encode(chunk: torch.Tensor, codebooks: torch.Tensor,
              eta: float = 0.0) -> torch.Tensor:
    """Encode one chunk → (B, m) uint8 codes; the chunk is unit-normalized
    first. ``eta`` must match the training objective."""
    m, _, ds = codebooks.shape
    x = l2_normalize(chunk.float())
    xs = x.reshape(x.shape[0], m, ds).transpose(0, 1)
    return torch.argmax(_aniso_fit(xs, codebooks.float(), eta), dim=-1).T.to(torch.uint8)


def _compute_dtype(device: torch.device) -> torch.dtype:
    """The dtype decode and scoring run in on ``device``: f32 on the CPU,
    bf16 on a GPU (products still summed in f32)."""
    return torch.float32 if torch.device(device).type == "cpu" else torch.bfloat16


def _decode_onehot(codes: torch.Tensor, cb: torch.Tensor,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(T, m) uint8 → (T, m, ds) through a one-hot product (the JAX
    package's decode); the (T, m, 256) one-hot bounds T (see PQ_TILE).
    ``out``: a (T, m·ds) tensor to write the rows into instead."""
    oh = torch.nn.functional.one_hot(codes.long(), cb.shape[1]).float()
    rec = torch.einsum("tmk,mkd->tmd", oh, cb.float()).to(cb.dtype)
    return rec if out is None else out.copy_(rec.reshape(out.shape))


# the element a codeword moves as in a gather: the widest of these whose
# size divides its bytes (a bf16 codeword of 8 dims is one 16-byte element)
_WORDS = (torch.complex128, torch.int64, torch.int32, torch.int16, torch.uint8)


def gather_codewords(cb: torch.Tensor, flat: torch.Tensor,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The rows of the (m, K, ds) codebooks that ``flat`` picks (integer
    indices into the m·K rows, any shape) → flat.shape + (ds,), or written
    into ``out`` (contiguous, flat.numel()·ds elements). The codebooks are
    read as one flat run of words (``_WORDS``), one index a word:
    ``index_select`` over rows of more than one element costs per row what
    it costs per element over single elements (PERF.md)."""
    m, k, ds = cb.shape
    word = next(w for w in _WORDS if (ds * cb.element_size()) % w.itemsize == 0)
    words = cb.contiguous().reshape(-1).view(word)
    per = ds * cb.element_size() // word.itemsize                      # words a codeword
    idx = flat.reshape(-1)
    if per > 1:
        idx = (idx[:, None] * per + torch.arange(per, device=idx.device,
                                                 dtype=idx.dtype)).reshape(-1)
    got = torch.index_select(words, 0, idx,
                             out=None if out is None else out.reshape(-1).view(word))
    return got.view(cb.dtype).reshape(*flat.shape, ds)


def _decode_gather(codes: torch.Tensor, cb: torch.Tensor,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(T, m) uint8 → (T, m, ds) by a gather from the codebooks: the same
    bits as ``_decode_onehot``. ``out`` as there."""
    m, k, _ = cb.shape
    # uint8 + int32 → int32 in one pass
    flat = codes + torch.arange(m, device=codes.device, dtype=torch.int32) * k
    return gather_codewords(cb, flat, out)


_DECODERS = {"onehot": _decode_onehot, "gather": _decode_gather}
# rows a decoder expands at once: the one-hot's (T, m, 256) transient, the
# gather's int32 index of a word per 16 bytes of codeword
_DECODE_CHUNK = {"onehot": 4096, "gather": 1 << 18}

# Two-level tiling, as in the JAX package: PQ_TILE bounds the one-hot decode
# transient; PQ_SCORE_TILE is the scan's scoring + selection granularity (a
# wide tile goes through the 128-bucket maxima of ``_local_topk``)
PQ_TILE = 4096
PQ_SCORE_TILE = 65536
# the kernels' path decodes 2M-row slices: 1.5 GB of bf16 rows at D = 384
PQ_SUPER_TILE = 1 << 21


def pq_pad_quantum(n: int) -> int:
    """Row-padding quantum for a code matrix of n real rows: whole score
    tiles once the corpus fills one, a single decode chunk otherwise."""
    return PQ_SCORE_TILE if n > PQ_SCORE_TILE else PQ_TILE


def _decode_rows(codes: torch.Tensor, cb: torch.Tensor, decode: str) -> torch.Tensor:
    """(T, m) uint8 → (T, D) reconstructions in ``cb``'s dtype, decoded in
    chunks (``_DECODE_CHUNK``) into one contiguous tensor."""
    T, m = codes.shape
    out = torch.empty((T, m * cb.shape[2]), dtype=cb.dtype, device=codes.device)
    step = _DECODE_CHUNK[decode]
    for lo in range(0, T, step):
        _DECODERS[decode](codes[lo:lo + step], cb, out[lo:lo + step])
    return out


def pq_topk(queries: torch.Tensor, codes: torch.Tensor, codebooks: torch.Tensor,
            n_real: int, k: int, decode: str = "gather",
            base: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``"xla"`` backend: scan the code matrix in PQ_SCORE_TILE tiles —
    decode, one (Q, D)×(D, tile) product, bucket-maxima top-k, merge into
    the running carry. ``codes`` is row-padded per :func:`pq_pad_quantum`;
    rows at or past ``n_real`` are masked; ``base`` offsets the returned
    positions. → (scores (Q, k) f32, positions (Q, k) int64)."""
    Q = queries.shape[0]
    n_pad = codes.shape[0]
    ST = PQ_SCORE_TILE if n_pad % PQ_SCORE_TILE == 0 else n_pad
    cd = _compute_dtype(codes.device)
    cb = codebooks.to(cd)
    q = l2_normalize(queries.float()).to(cd).float()
    kk = min(k, ST)
    cs = torch.full((Q, kk), float("-inf"), device=codes.device)
    ci = torch.full((Q, kk), -1, dtype=torch.int64, device=codes.device)
    col = torch.arange(ST, device=codes.device)
    for t0 in range(0, n_pad, ST):
        s = q @ _decode_rows(codes[t0:t0 + ST], cb, decode).float().T
        s = torch.where(col[None, :] + t0 < n_real, s, float("-inf"))
        s1, p1 = _local_topk(s, kk)
        cs, ci = _merge_topk(cs, ci, s1, p1 + t0, kk)
    ci = torch.where(ci >= 0, ci + base, ci)
    if kk < k:   # a tiny corpus: top up to k with -inf slots
        cs = torch.nn.functional.pad(cs, (0, k - kk), value=float("-inf"))
        ci = torch.nn.functional.pad(ci, (0, k - kk), value=-1)
    return cs, ci


def _pq_super_tile_topk(queries: torch.Tensor, codes_slice: torch.Tensor,
                        codebooks: torch.Tensor, n_local: int, base: int, k: int,
                        decode: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """One slice of the kernels' path: decode the slice to rows in the
    compute dtype, then ``topk_local`` (K4 → selection → K5) over them.
    → (scores (Q, k), global positions (Q, k))."""
    cd = _compute_dtype(codes_slice.device)
    q = l2_normalize(queries.float()).to(cd)
    recon = _decode_rows(codes_slice, codebooks.to(cd), decode)
    s, i = topk_local(q, recon, k, n_local)
    return s, torch.where(i >= 0, i + base, i)


def _pallas_scan(queries: torch.Tensor, codes: torch.Tensor, codebooks: torch.Tensor,
                 n_real: int, k: int, decode: str = "gather",
                 base: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels' path over a code matrix (``pq_topk``'s contract): decode
    PQ_SUPER_TILE-row slices and run ``topk_local`` over each, merging the
    (Q, k) winners exactly. → (scores (Q, k), positions + ``base``)."""
    n_pad = codes.shape[0]
    cs = torch.full((queries.shape[0], k), float("-inf"), device=codes.device)
    ci = torch.full((queries.shape[0], k), -1, dtype=torch.int64, device=codes.device)
    for lo in range(0, n_pad, PQ_SUPER_TILE):
        hi = min(lo + PQ_SUPER_TILE, n_pad)
        s, i = _pq_super_tile_topk(queries, codes[lo:hi], codebooks,
                                   max(0, min(n_real - lo, hi - lo)), base + lo, k, decode)
        cs, ci = _merge_topk(cs, ci, s, i, k)
    return cs, ci


def _merge_topk(cs, ci, s, i, k: int):
    s2, pos = torch.topk(torch.cat([cs, s], dim=1), k, dim=1)
    return s2, torch.gather(torch.cat([ci, i], dim=1), 1, pos)


# The refine re-scores a small candidate pool (k·refine_factor rows a
# query): host BLAS does it without sending the gathered rows to the
# device. False routes it through the device (``_refine_rescore``).
REFINE_ON_HOST = True


def _refine_rescore_host(queries, cand_rows: np.ndarray, cand_idx: np.ndarray, k: int,
                         inv_scale: float) -> Tuple[np.ndarray, np.ndarray]:
    """Host exact re-rank: same contract as :func:`_refine_rescore` (scores
    descending, −1 candidates excluded), numpy in and out."""
    q = np.asarray(queries, np.float32)
    q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    cand = np.asarray(cand_rows, np.float32)
    if inv_scale != 1.0:
        cand *= np.float32(inv_scale)
    s = np.matmul(cand, q[:, :, None]).squeeze(-1)       # (Q, K')
    s[cand_idx < 0] = -np.inf
    k = min(k, s.shape[1])
    if k < s.shape[1]:
        part = np.argpartition(-s, k - 1, axis=1)[:, :k]
    else:
        part = np.broadcast_to(np.arange(k), s.shape[:1] + (k,))
    ps = np.take_along_axis(s, part, axis=1)
    order = np.argsort(-ps, axis=1, kind="stable")
    pos = np.take_along_axis(part, order, axis=1)
    return (np.take_along_axis(s, pos, axis=1),
            np.take_along_axis(cand_idx, pos, axis=1))


def _rows_at(table, idx: np.ndarray) -> np.ndarray:
    """Rows of a host refine table at positions ``idx``: float32 for a
    bf16 torch table (exact), the table's own dtype for a numpy one."""
    if isinstance(table, torch.Tensor):
        return table[torch.from_numpy(np.ascontiguousarray(idx))].float().numpy()
    return table[idx]


def _host_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def refine_pair(queries, rows_table, idx: np.ndarray, k: int, scale: float,
                n_docs: int) -> Tuple[np.ndarray, np.ndarray]:
    """Gather candidate rows from the host refine table and re-rank them
    exactly: the one refine entry point of every index family and the
    Retriever. Host numpy by default (:data:`REFINE_ON_HOST`), the device
    otherwise (the queries' device when they are a tensor)."""
    idx = np.asarray(idx)
    cand = _rows_at(rows_table, np.clip(idx, 0, n_docs - 1))
    k = min(k, idx.shape[1])
    if REFINE_ON_HOST:
        return _refine_rescore_host(_host_f32(queries), cand, idx, k, 1.0 / scale)
    q = torch.as_tensor(queries).float()
    s, i = _refine_rescore(q, torch.from_numpy(cand).to(q.device),
                           torch.from_numpy(idx).to(q.device), k, 1.0 / scale)
    return s.cpu().numpy(), i.cpu().numpy()


def _refine_rescore(queries: torch.Tensor, cand_rows: torch.Tensor, cand_idx: torch.Tensor,
                    k: int, inv_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact re-rank of gathered candidate rows: one product over the
    (Q, K', D) candidates, masked where the scan returned −1. ``inv_scale``
    de-quantizes int8 rows (1.0 for float rows)."""
    q = l2_normalize(queries.float())
    s = torch.einsum("qd,qkd->qk", q, cand_rows.float() * np.float32(inv_scale))
    s = torch.where(cand_idx >= 0, s, float("-inf"))
    s2, pos = torch.topk(s, k, dim=1)
    return s2, torch.gather(cand_idx, 1, pos)


_KEEP_ROWS = (False, True, "bfloat16", "int8")


def _refine_table(keep_rows, n: int, d: int):
    """An empty host refine table for ``keep_rows`` → (table, scale):
    True/"bfloat16" a CPU bf16 tensor, "int8" a numpy int8 array at the
    fixed scale 127 (unit rows have |component| ≤ 1), False none."""
    if keep_rows not in _KEEP_ROWS:
        raise ValueError(f"keep_rows must be bool | 'bfloat16' | 'int8', got {keep_rows!r}")
    if keep_rows == "int8":
        return np.empty((n, d), np.int8), 127.0
    if keep_rows:
        return torch.empty((n, d), dtype=torch.bfloat16), 1.0
    return None, 1.0


def _refine_rows_of(unit: torch.Tensor, scale: float):
    """A chunk of unit rows as stored in a refine table of ``scale``."""
    if scale != 1.0:
        return torch.clamp(torch.round(unit * 127.0), -127, 127).to(torch.int8).cpu().numpy()
    return unit.to(torch.bfloat16).cpu()


def _adopt_refine_rows(rows, n: int, d: int):
    """Persisted refine rows → (table, scale): int8 rows verbatim at scale
    127, any float rows as a CPU bf16 tensor (exact for rows saved from
    bf16 as f32)."""
    if rows is None:
        return None, 1.0
    if tuple(rows.shape) != (n, d):
        raise ValueError(f"refine_rows shape {tuple(rows.shape)} != {(n, d)}")
    if isinstance(rows, torch.Tensor):
        if rows.dtype == torch.int8:
            return rows.cpu().numpy(), 127.0
        return rows.detach().to("cpu", torch.bfloat16), 1.0
    rows = np.asarray(rows)
    if rows.dtype == np.int8:
        return rows, 127.0
    return torch.from_numpy(np.asarray(rows, np.float32)).to(torch.bfloat16), 1.0


def _refine_rows_f32(table, scale: float) -> Optional[np.ndarray]:
    if table is None:
        return None
    rows = _host_f32(table)
    return rows / np.float32(scale) if scale != 1.0 else rows


class PQIndex:
    """Product-quantized cosine index: m bytes a doc on the device, an
    optional exact re-rank from host rows.

    ``embeddings`` may be a host array (a memmap is read chunk by chunk) or
    a tensor; the index lives on ``device`` (default: a tensor's own
    device; host arrays go to the GPU). ``keep_rows`` keeps the
    unit-normalized originals in host memory: True/"bfloat16" at 2 B/dim,
    "int8" at 1 B/dim (scale 127)."""

    PALLAS_MIN_DOCS = 65536        # below this the plain scan wins
    PALLAS_MIN_SHARD_DOCS = 16384  # the per-shard threshold (as ExactIndex)
    PALLAS_MIN_QUERIES = 256
    DEFAULT_REFINE = 8

    def __init__(self, embeddings, m: int = 48, ids: Optional[list] = None,
                 n_iters: int = 12, train_sample: int = 131072, seed: int = 0,
                 mesh: Any = None, keep_rows=False, encode_chunk: int = 1 << 16,
                 codebooks=None, rotate: bool = False, rotation=None,
                 anisotropic: float = 0.0, device: Any = None):
        # encode_chunk bounds pq_encode's (B, m, 256) f32 fit (~3.2 GB at
        # 65,536 rows, m = 48). rotate / rotation quantize in a rotated
        # basis; refine rows and refined scores stay in the original one
        mesh = as_mesh(mesh)
        if mesh is not None and device is None:
            device = mesh.devices[0]
        self.device = device_of(embeddings, device)
        emb = embeddings if isinstance(embeddings, torch.Tensor) else np.asarray(embeddings)
        n, d = emb.shape
        if n == 0:
            raise ValueError("empty corpus")
        if d % m != 0:
            raise ValueError(f"dim {d} not divisible by m={m}")
        if m % 8 != 0:
            raise ValueError(f"m must be a multiple of 8, got {m}")
        if anisotropic < 0:
            raise ValueError(f"anisotropic must be >= 0, got {anisotropic}")
        self.m, self.dim, self.n_docs = m, d, n
        self._eta = float(anisotropic)
        self.ids = list(ids) if ids is not None else list(range(n))
        if len(self.ids) != n:
            raise ValueError("ids length mismatch")
        self._rotation = None
        if rotation is not None:
            self._rotation = _tensor(rotation).float().to(self.device)
            if tuple(self._rotation.shape) != (d, d):
                raise ValueError(f"rotation shape {tuple(self._rotation.shape)} != {(d, d)}")
        elif rotate:
            self._rotation = random_rotation(d, seed).to(self.device)

        rows = row_reader(emb, self.device)
        if codebooks is not None:
            self.codebooks = _tensor(codebooks).float().to(self.device)
            if tuple(self.codebooks.shape) != (m, K_CENTROIDS, d // m):
                raise ValueError(f"codebooks shape {tuple(self.codebooks.shape)} != "
                                 f"{(m, K_CENTROIDS, d // m)}")
        else:
            if n < K_CENTROIDS:
                raise ValueError(
                    f"need ≥{K_CENTROIDS} docs to train codebooks (got {n}); "
                    "pass codebooks= to reuse pre-trained ones")
            gen = torch.Generator().manual_seed(seed)
            sample = sample_rows(n, train_sample, rows, gen).float()
            if self._rotation is not None:
                sample = sample @ self._rotation
            self.codebooks = pq_train(sample, gen, m, n_iters, eta=self._eta)
            del sample

        self._refine_rows, self._refine_scale = _refine_table(keep_rows, n, d)
        quantum = pq_pad_quantum(n)
        codes = torch.zeros((-(-n // quantum) * quantum, m), dtype=torch.uint8,
                            device=self.device)
        for lo in range(0, n, encode_chunk):
            hi = min(lo + encode_chunk, n)
            chunk = rows(slice(lo, hi)).float()
            enc_in = chunk if self._rotation is None else chunk @ self._rotation
            codes[lo:hi] = pq_encode(enc_in, self.codebooks, eta=self._eta)
            if self._refine_rows is not None:
                self._refine_rows[lo:hi] = _refine_rows_of(l2_normalize(chunk),
                                                           self._refine_scale)
        self._install_codes(codes, mesh)

    def _install_codes(self, codes: torch.Tensor, mesh) -> None:
        """Place the (quantum-padded) code matrix on the index's device —
        split over the mesh when given, ``shard_rows`` rows a shard: the
        ceiling of the padded rows over the shards, rounded up to the
        quantum of that many rows; ``self.codes`` is then a
        :class:`RowShards` (``gathered`` reads it whole)."""
        self.mesh = sharded(mesh)
        if self.mesh is None:
            self.codes = codes.to(self.device)
            return
        raw = -(-codes.shape[0] // self.mesh.size)
        quantum = pq_pad_quantum(raw)
        self.shard_rows = -(-raw // quantum) * quantum
        codes = torch.nn.functional.pad(
            codes, (0, 0, 0, self.shard_rows * self.mesh.size - codes.shape[0]))
        self.codes = RowShards(codes.to(self.device), self.mesh, self.shard_rows)

    @classmethod
    def from_chunks(cls, chunks, m: int = 48, ids: Optional[list] = None, mesh: Any = None,
                    n_iters: int = 12, train_sample: int = 131072, seed: int = 0,
                    rotate: bool = False, anisotropic: float = 0.0,
                    device: Any = None) -> "PQIndex":
        """Build from an iterable of (B, D) host chunks: the corpus never
        exists as one array. Chunks are buffered only until ``train_sample``
        rows are seen (the codebooks train on them), the rest stream through
        the encoder. No refine rows."""
        mesh = as_mesh(mesh)
        dev = device_of(None, device if device is not None or mesh is None
                        else mesh.devices[0])
        it = iter(chunks)
        buffered: List[np.ndarray] = []
        n_buffered = 0
        for chunk in it:
            buffered.append(np.asarray(chunk, np.float32))
            n_buffered += buffered[-1].shape[0]
            if n_buffered >= train_sample:
                break
        if n_buffered < K_CENTROIDS:
            raise ValueError(f"need ≥{K_CENTROIDS} docs to train codebooks "
                             f"(got {n_buffered})")
        sample = torch.from_numpy(np.concatenate(buffered)[:train_sample]).to(dev)
        d = sample.shape[1]
        if d % m != 0:
            raise ValueError(f"dim {d} not divisible by m={m}")
        if m % 8 != 0:
            raise ValueError(f"m must be a multiple of 8, got {m}")
        rot = random_rotation(d, seed).to(dev) if rotate else None
        codebooks = pq_train(sample if rot is None else sample @ rot,
                             torch.Generator().manual_seed(seed), m, n_iters, eta=anisotropic)
        parts = []
        for chunk in itertools.chain(buffered, it):
            x = torch.from_numpy(np.asarray(chunk, np.float32)).to(dev)
            parts.append(pq_encode(x if rot is None else x @ rot, codebooks, eta=anisotropic))
        self = cls.from_codes(torch.cat(parts), codebooks, ids=ids, mesh=mesh, rotation=rot,
                              device=dev)
        self._eta = float(anisotropic)
        return self

    @classmethod
    def from_codes(cls, codes, codebooks, ids: Optional[list] = None, mesh: Any = None,
                   refine_rows=None, rotation=None, device: Any = None) -> "PQIndex":
        """Rebuild an index from persisted artifacts — no training, no
        encoding (the Retriever reload path, and how a JAX-built index is
        carried over). ``refine_rows`` are the unit-normalized originals:
        int8 (scale 127) or any float dtype (kept as bf16)."""
        mesh = as_mesh(mesh)
        if mesh is not None and device is None:
            device = mesh.devices[0]
        self = cls.__new__(cls)
        self.device = device_of(codes, device)
        codes = codes.to(torch.uint8) if isinstance(codes, torch.Tensor) \
            else torch.from_numpy(np.array(codes, np.uint8))
        n, m = codes.shape
        cb = _tensor(codebooks).float().to(self.device)
        if cb.ndim != 3 or cb.shape[0] != m or cb.shape[1] != K_CENTROIDS:
            raise ValueError(f"codebooks shape {tuple(cb.shape)} does not match codes "
                             f"with m={m}")
        self.m, self.dim, self.n_docs = m, m * cb.shape[2], n
        self.codebooks = cb
        self._eta = 0.0   # search is eta-free; it matters only for re-encoding
        self._rotation = None
        if rotation is not None:
            self._rotation = _tensor(rotation).float().to(self.device)
            if tuple(self._rotation.shape) != (self.dim, self.dim):
                raise ValueError(f"rotation shape {tuple(self._rotation.shape)} != "
                                 f"{(self.dim, self.dim)}")
        self.ids = list(ids) if ids is not None else list(range(n))
        if len(self.ids) != n:
            raise ValueError("ids length mismatch")
        self._refine_rows, self._refine_scale = _adopt_refine_rows(refine_rows, n, self.dim)
        quantum = pq_pad_quantum(n)
        n_pad = -(-n // quantum) * quantum
        self._install_codes(torch.nn.functional.pad(codes, (0, 0, 0, n_pad - n)), mesh)
        return self

    @property
    def bytes_per_doc(self) -> int:
        return self.m

    def refine_rows_f32(self) -> Optional[np.ndarray]:
        """The refine rows as f32 unit vectors (int8 de-quantized)."""
        return _refine_rows_f32(self._refine_rows, self._refine_scale)

    def reconstruction_mse(self, sample) -> float:
        """Mean squared reconstruction error of a sample (the PQ objective)."""
        x = l2_normalize(torch.as_tensor(sample, device=self.device).float())
        if self._rotation is not None:
            x = x @ self._rotation
        codes = pq_encode(x, self.codebooks, eta=self._eta)
        recon = _decode_rows(codes, self.codebooks.to(_compute_dtype(self.device)), "gather")
        return float(torch.mean((x - recon.float()) ** 2))

    def _queries(self, queries) -> torch.Tensor:
        return torch.as_tensor(queries, device=self.device).float()

    def _device_search(self, queries, k: int, score: str = "cos_sim", tile: int = 0,
                       backend: str = "auto", decode: str = "gather"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One search, device tensors returned (not synchronized): the
        positional contract of ``ExactIndex._device_search`` so the
        Retriever drives either; ``tile`` is accepted and unused."""
        if score not in ("cos_sim", "dot_score"):
            raise ValueError("PQ index supports cos_sim/dot_score only "
                             "(rows are normalized at encode time)")
        if decode not in _DECODERS:
            raise ValueError(f"unknown decode {decode!r}; choices: {sorted(_DECODERS)}")
        if backend not in ("auto", "pallas", "xla"):
            raise ValueError(f"unknown backend {backend!r}")
        k = min(k, self.n_docs)
        q = self._queries(queries)
        if self._rotation is not None:
            # orthogonal: normalize-then-rotate equals rotate-then-normalize
            q = q @ self._rotation
        use_pallas = backend == "pallas" or (backend == "auto"
                                             and self._pallas_eligible(k, q.shape[0]))
        scan = _pallas_scan if use_pallas else pq_topk
        if self.mesh is None:
            return scan(q, self.codes, self.codebooks, self.n_docs, k, decode=decode)
        blocks = self.codes.blocks
        qs, cbs = replicate(q, self.mesh), replicate(self.codebooks, self.mesh)

        def shard(i: int, dev):
            base = i * self.shard_rows
            return scan(qs[dev], blocks[i], cbs[dev],
                        max(0, min(self.n_docs - base, self.shard_rows)), k,
                        decode=decode, base=base)

        return merge_topk(shard_loop(self.mesh, shard), k, self.device)

    def _pallas_eligible(self, k: int, n_queries: int) -> bool:
        big_enough = (self.n_docs >= self.PALLAS_MIN_DOCS if self.mesh is None
                      else self.shard_rows >= self.PALLAS_MIN_SHARD_DOCS)
        return (k <= 128 and big_enough
                and n_queries >= self.PALLAS_MIN_QUERIES and self.device.type != "cpu")

    def search(self, queries, k: int = 10, refine_factor: Optional[int] = None,
               decode: str = "gather", score: str = "cos_sim",
               backend: str = "auto") -> Tuple[np.ndarray, np.ndarray]:
        """→ (scores (Q, k), positions (Q, k)) as numpy. ``refine_factor=r``
        re-ranks the top r·k candidates exactly from the host rows (needs
        ``keep_rows``); default: DEFAULT_REFINE when refine rows exist, else
        0 (the PQ scores). cos_sim and dot_score are the same here."""
        if refine_factor is None:
            refine_factor = self.DEFAULT_REFINE if self._refine_rows is not None else 0
        if refine_factor and self._refine_rows is None:
            raise ValueError("refine_factor needs keep_rows=True at build time")
        kk = min(k * refine_factor, self.n_docs) if refine_factor else k
        s, i = self._device_search(queries, kk, score, decode=decode, backend=backend)
        if refine_factor:
            return refine_pair(queries, self._refine_rows, i.cpu().numpy(),
                               min(k, self.n_docs), self._refine_scale, self.n_docs)
        return s.cpu().numpy(), i.cpu().numpy()

    def search_ids(self, queries, k: int = 10, refine_factor: Optional[int] = None,
                   score: str = "cos_sim"):
        s, i = self.search(queries, k, refine_factor, score=score)
        return s, [[self.ids[j] if j >= 0 else None for j in row] for row in i]

    def search_stream(self, query_batches, k: int = 10, depth: int = 4,
                      decode: str = "gather", refine_factor: Optional[int] = None):
        """Pipelined serving loop: yields ``(scores, positions)`` numpy pairs
        in input order with up to ``depth`` searches queued on the device.
        ``refine_factor`` (default 0) re-ranks each batch as it is taken off
        the queue, while the later batches compute."""
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        refine = refine_factor or 0
        if refine and self._refine_rows is None:
            raise ValueError("refine_factor needs keep_rows=True at build time")
        kk = min(k * refine, self.n_docs) if refine else k

        def finish(queries, s, i):
            if not refine:
                return s.cpu().numpy(), i.cpu().numpy()
            return refine_pair(queries, self._refine_rows, i.cpu().numpy(),
                               min(k, self.n_docs), self._refine_scale, self.n_docs)

        pending: list = []
        for q in query_batches:
            pending.append((q, *self._device_search(q, kk, decode=decode)))
            if len(pending) >= depth:
                yield finish(*pending.pop(0))
        while pending:
            yield finish(*pending.pop(0))
