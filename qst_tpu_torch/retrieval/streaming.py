"""Host-streamed exact search over corpora larger than device memory —
counterpart of ``qst_tpu/retrieval/streaming.py``.

The corpus stays in host memory or an ``np.memmap`` on disk and crosses to
the device in ``tile_rows``-row tiles. Each tile runs the exact pipeline of
the in-memory index — ``topk_local`` (K4 with the tile's valid-row count →
bucket selection → K5) on the ``"pallas"`` path, or the plain product and
``_local_topk`` on the ``"xla"`` path — and a (Q, k) carry merges the
tiles' winners: exact, by the same argument that composes buckets inside
one tile.

**The double buffer** (a GPU index). The JAX package overlaps the next
tile's transfer with this tile's search through asynchronous
``jax.device_put``. Here: two pinned host staging buffers and two device
buffers; the host fills staging buffer t % 2 while the device searches tile
t − 1, then a copy stream sends it (``non_blocking``: from pinned memory the
copy is asynchronous). Two events per buffer order it: the search of a tile
waits for its copy (``copied``), and the copy into a device buffer waits
until the search of the tile that last used it has read it (``read``) —
without that event the copy of tile t + 2 could overwrite tile t while K4
and K5 still read it. The host waits for a copy out of a staging buffer
before refilling it.

**Where the host work goes.** The stream is bound by the host's copy of
each tile out of the memmap into pinned memory. bf16 transfers of an f32
corpus cast on the host, inside that copy (torch's parallel converting
copy: numpy has no bfloat16), which writes and sends half the bytes;
sending f32 and casting on the device gives the same bits
(round-to-nearest-even in both places) and was slower on an H100 host
(``PERF.md``). int8 transfers normalize and quantize each tile on
the host under a per-tile scale with the JAX package's numpy row norms (a
device version would sum the norms in another order and could flip a
rounding), the elementwise rest in torch, rows split over threads, which
changes no row's arithmetic. A pre-quantized int8 corpus
(``quantize_host``) streams verbatim at the fixed scale 127.

**A mesh** (``mesh=``, ``core/meshes.py``) splits every tile row-wise into
``tile_rows / mesh.size`` rows a shard (``tile_rows`` a multiple of 128
times the shard count, the JAX tile quantum), shard i on
``mesh.devices[i]``. Each shard runs the tile's search over its rows with
its host-int share of the tile's valid count, and the shards' candidates
merge with the running carry in shard order (``core/meshes.py:merge_topk``;
the unsharded index is the one-shard case). The host staging buffers are
one pair for all shards; each distinct device has one copy stream, one
pair of device buffers holding its shards' rows (one copy for a run of
adjacent shards) and its own ``copied`` / ``read`` events.
"""

from __future__ import annotations

import os
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator, Optional, Tuple

import numpy as np
import torch

from qst_tpu_torch.core.device import resolve_device
from qst_tpu_torch.core.meshes import as_mesh, merge_topk, replicate, shard_loop
from qst_tpu_torch.ops.distances import l2_normalize
from qst_tpu_torch.ops.topk import topk_local
from qst_tpu_torch.retrieval.index import BUCKET, _local_topk

_TRANSFER = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}
_HOST_BLOCK = 1 << 16      # rows a host thread quantizes at a time


def _host_tensor(rows: np.ndarray) -> torch.Tensor:
    """A CPU tensor over host rows, read-only memmaps included (torch warns
    that it may not write them; nothing here writes)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(rows)


def _quantize_rows(chunk: np.ndarray, out: np.ndarray) -> float:
    """Unit-normalize float rows and quantize them into ``out`` (int8)
    under the scale 127 / max|normalized|, in the JAX package's arithmetic,
    rows split over threads; → the scale. The row norms are numpy's (the
    one step whose summation order could flip a rounding); the rest is
    elementwise IEEE arithmetic, which torch's kernels do alike."""
    blocks = [(lo, min(lo + _HOST_BLOCK, chunk.shape[0]))
              for lo in range(0, chunk.shape[0], _HOST_BLOCK)]
    den = np.empty((chunk.shape[0], 1), np.float32)

    def norms(lo, hi):
        x = np.asarray(chunk[lo:hi], np.float32)
        den[lo:hi] = np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
        # division by a positive number keeps the order, so the largest
        # normalized element of a row is its largest |x| over its norm
        return float((np.abs(x).max(axis=1, keepdims=True) / den[lo:hi]).max())

    def quantize(lo, hi, scale):
        x = _host_tensor(np.asarray(chunk[lo:hi], np.float32)) / torch.from_numpy(den[lo:hi])
        out[lo:hi] = x.mul_(np.float32(scale)).round_().clamp_(-127, 127).to(torch.int8).numpy()

    with ThreadPoolExecutor(max(1, min(len(blocks), os.cpu_count() or 1))) as pool:
        top = max(pool.map(lambda b: norms(*b), blocks))
        scale = 127.0 / max(top, 1e-12)
        list(pool.map(lambda b: quantize(*b, scale), blocks))
    return scale


class StreamingExactIndex:
    """Exact top-k over a host-resident corpus (an ``np.ndarray`` or
    ``np.memmap``, never copied whole), streamed tile by tile through the
    device (``device``, default the GPU)."""

    INT8_SCALE = 127.0   # pre-quantized host arrays: unit rows bound |component| ≤ 1
    # tiles quantized from a float corpus on the fly use a per-tile scale
    # 127 / max|tile| instead (finer); the merge descales each tile

    def __init__(self, embeddings: np.ndarray, tile_rows: int = 1 << 21,
                 normalize: bool = False, transfer_dtype: str = "bfloat16",
                 ids: Optional[list] = None, mesh: Any = None, device: Any = None):
        """``normalize``: L2-normalize every tile on the device
        (``ExactIndex(normalize=True)`` semantics for dot searches).
        ``mesh``: split every tile over the mesh's devices (the module's
        docstring); the results land on its first device."""
        mesh = as_mesh(mesh)
        if mesh is not None and device is None:
            device = mesh.home
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        if embeddings.ndim != 2 or embeddings.shape[0] == 0:
            raise ValueError(f"embeddings must be (N, D), got {embeddings.shape}")
        n_shards = self.mesh.size if self.mesh is not None else 1
        row_quantum = BUCKET * n_shards
        if tile_rows % row_quantum != 0 or tile_rows <= 0:
            raise ValueError(f"tile_rows must be a positive multiple of {row_quantum} "
                             f"(128 × mesh devices), got {tile_rows}")
        if transfer_dtype not in _TRANSFER:
            raise ValueError(f"transfer_dtype must be float32|bfloat16|int8, got"
                             f" {transfer_dtype}")
        if transfer_dtype == "int8":
            if normalize:
                raise ValueError("transfer_dtype='int8' always normalizes (quantization "
                                 "needs unit rows); drop normalize=True")
            if embeddings.shape[1] * 127 * 127 >= 1 << 24:
                raise ValueError(f"dim {embeddings.shape[1]} too wide for int8 "
                                 "(D·127² must stay below 2^24 for exact f32 sums)")
        self.embeddings = embeddings
        self.n_docs, self.dim = embeddings.shape
        self.tile_rows = tile_rows
        self._normalize_on_device = normalize
        self.transfer_dtype = _TRANSFER[transfer_dtype]
        self.ids = list(ids) if ids is not None else None
        if self.ids is not None and len(self.ids) != self.n_docs:
            raise ValueError("ids length mismatch")
        self.device = resolve_device(device)
        # (device, first row) of each shard of a tile: one shard without a mesh
        self._shard_rows = tile_rows // n_shards
        self._shards = [(d, i * self._shard_rows) for i, d in
                        enumerate(self.mesh.devices if self.mesh is not None else [self.device])]
        # the shards this process runs (another process's shards get no copy)
        self._owned = [self.mesh is None or self.mesh.owns(i) for i in range(len(self._shards))]

    @classmethod
    def from_npy(cls, path: str, **kw) -> "StreamingExactIndex":
        """Memory-map a ``.npy`` corpus from disk: the searchable corpus is
        then bounded by disk, not memory."""
        return cls(np.load(path, mmap_mode="r"), **kw)

    @staticmethod
    def quantize_host(rows: np.ndarray) -> np.ndarray:
        """Unit-normalize and quantize rows to the fixed-scale int8 scheme: a
        half-size host or disk corpus that streams verbatim."""
        rows = np.asarray(rows, np.float32)
        rows = rows / np.maximum(np.linalg.norm(rows, axis=1, keepdims=True), 1e-12)
        return np.clip(np.round(rows * StreamingExactIndex.INT8_SCALE),
                       -127, 127).astype(np.int8)

    def _fill_tile(self, t: int, out: torch.Tensor) -> float:
        """Write tile t into the host tensor ``out`` (tile_rows, D) in the
        transfer dtype — cast, or normalized and quantized for int8, the last
        tile zero-padded. → the tile's quantization scale (1.0 for float)."""
        lo = t * self.tile_rows
        n = min(lo + self.tile_rows, self.n_docs) - lo
        chunk = self.embeddings[lo:lo + n]
        scale = 1.0
        if out.dtype == torch.int8 and chunk.dtype != np.int8:
            scale = _quantize_rows(chunk, out.numpy()[:n])
        else:
            if out.dtype == torch.int8:
                scale = self.INT8_SCALE
            out[:n].copy_(_host_tensor(np.asarray(chunk)))
        out[n:] = 0
        return scale

    def _tiles(self) -> Iterator[Tuple[int, list, float]]:
        """Yield (t, [tile t's block of each shard on its device], scale) for
        every tile, in the transfer dtype. On a GPU the next tile is prepared
        and copied while the caller's work on this one runs; a tile stays
        valid until the next is asked for, and the caller's work on it must
        be queued on each device's current stream by then."""
        dtype = self.transfer_dtype
        shape = (self.tile_rows, self.dim)
        sr = self._shard_rows
        n_tiles = -(-self.n_docs // self.tile_rows)
        if self.device.type != "cuda":
            for t in range(n_tiles):
                buf = torch.empty(shape, dtype=dtype)
                scale = self._fill_tile(t, buf)
                yield t, [buf[lo:lo + sr].to(d) if mine else None
                          for (d, lo), mine in zip(self._shards, self._owned)], scale
            return
        # each device's shards, in order; a device buffer holds their rows
        own = {}
        for i, (d, _) in enumerate(self._shards):
            if self._owned[i]:
                own.setdefault(d, []).append(i)
        pinned = [torch.empty(shape, dtype=dtype, pin_memory=True) for _ in range(2)]
        copy_stream = {d: torch.cuda.Stream(d) for d in own}
        dev = {d: [torch.empty((len(ix) * sr, self.dim), dtype=dtype, device=d)
                   for _ in range(2)] for d, ix in own.items()}
        for d, bufs in dev.items():
            for b in bufs:
                b.record_stream(copy_stream[d])
        copied = {d: [torch.cuda.Event() for _ in range(2)] for d in own}
        read = {d: [torch.cuda.Event() for _ in range(2)] for d in own}
        # runs of adjacent shards a device owns: one copy each, (dst row, src row, rows)
        runs = {}
        for d, ix in own.items():
            runs[d] = []
            for j, i in enumerate(ix):
                if runs[d] and ix[j - 1] == i - 1:
                    dst, src, n = runs[d][-1]
                    runs[d][-1] = (dst, src, n + sr)
                else:
                    runs[d].append((j * sr, i * sr, sr))
        # shard i's block: a view of its device's buffer
        where = [(d, own[d].index(i) * sr) if self._owned[i] else None
                 for i, (d, _) in enumerate(self._shards)]
        scales = [1.0, 1.0]

        def send(t: int) -> None:
            b = t % 2
            for d in own:                    # staging b is free: tile t − 2's copies are done
                copied[d][b].synchronize()
            scales[b] = self._fill_tile(t, pinned[b])
            for d in own:
                copy_stream[d].wait_event(read[d][b])   # device b: tile t − 2 was searched
                with torch.cuda.stream(copy_stream[d]):
                    for dst, src, n in runs[d]:
                        dev[d][b][dst:dst + n].copy_(pinned[b][src:src + n], non_blocking=True)
                    copied[d][b].record(copy_stream[d])

        try:
            send(0)
            for t in range(n_tiles):
                b = t % 2
                for d in own:
                    torch.cuda.current_stream(d).wait_event(copied[d][b])
                yield t, [None if w is None else dev[w[0]][b][w[1]:w[1] + sr]
                          for w in where], scales[b]
                for d in own:
                    read[d][b].record(torch.cuda.current_stream(d))
                if t + 1 < n_tiles:
                    send(t + 1)
        finally:
            # torn down with the pass, also when the caller stops early: no
            # copy left in flight into buffers that are about to be freed
            # (the pinned ones go back to torch's host cache)
            for st in copy_stream.values():
                st.synchronize()

    def search(self, queries, k: int = 10, score: str = "cos_sim",
               backend: str = "auto") -> Tuple[np.ndarray, np.ndarray]:
        """→ (scores (Q, k), positions (Q, k)) as numpy, exact over the whole
        host corpus: one pass over it a call (batch the queries). backend:
        "auto" takes the kernels (K4 + K5) on a GPU for k ≤ 128, "pallas" /
        "xla" force one (on a CPU index "pallas" runs the plain versions)."""
        if score not in ("cos_sim", "dot_score"):
            raise ValueError(f"streaming search supports cos_sim|dot_score, got {score!r}")
        if backend not in ("auto", "pallas", "xla"):
            raise ValueError(f"unknown backend {backend!r}")
        use_pallas = backend == "pallas" or (backend == "auto" and self.device.type != "cpu")
        k = min(k, self.n_docs)
        if k > 128 and use_pallas:
            if backend == "pallas":
                raise ValueError("pallas backend supports k <= 128")
            use_pallas = False
        qq = torch.as_tensor(queries, device=self.device).float()
        if score == "cos_sim":
            qq = l2_normalize(qq)
        qscale = None
        if self.transfer_dtype == torch.int8:
            # ExactIndex-int8 scheme: a per-call symmetric query scale; the
            # integer scores descale back to the cosine domain per tile
            qscale = 127.0 / torch.clamp(qq.abs().max(), min=1e-12)
            qq = torch.clamp(torch.round(qq * qscale), -127, 127).to(torch.int8)
        else:
            qq = qq.to(self.transfer_dtype)
        # float tiles normalize on the device when the score needs it or the
        # index was built with normalize=True; int8 tiles come normalized
        normalize = (self.transfer_dtype != torch.int8
                     and (self._normalize_on_device or score == "cos_sim"))
        Q = qq.shape[0]
        cs = torch.full((Q, k), float("-inf"), device=self.device)
        ci = torch.full((Q, k), -1, dtype=torch.int64, device=self.device)
        mesh = self.mesh
        qs = replicate(qq, mesh) if mesh is not None else {self.device: qq}
        for t, blocks, scale in self._tiles():
            base = t * self.tile_rows
            n_valid = min(self.n_docs - base, self.tile_rows)
            inv = 1.0 if qscale is None else 1.0 / (qscale * scale)
            invs = ({d: inv for d in qs} if qscale is None
                    else {d: inv.to(d) for d in qs})

            def shard(i: int, dev):
                lo = self._shards[i][1]
                s, idx = self._tile_step(qs[dev], blocks[i], max(0, min(n_valid - lo,
                                         self._shard_rows)), k, use_pallas, normalize)
                return s * invs[dev], idx + (base + lo)

            parts = (shard_loop(mesh, shard) if mesh is not None
                     else [shard(0, self.device)])
            if mesh is not None and mesh.spans_processes:
                # the carry is every process's already: merge the shards
                # across processes first (the same top k: the carry wins
                # ties either way, the shards keep their order)
                parts = [merge_topk(parts, k, self.device)]
            cs, ci = merge_topk([(cs, ci)] + parts, k, self.device)
        return cs.cpu().numpy(), ci.cpu().numpy()

    @staticmethod
    def _tile_step(queries, block, n_valid: int, k: int, use_pallas: bool, normalize: bool):
        """Search one shard's block of a tile: → (scores, rows in the
        block). The caller descales int8 tiles' integer scores into the
        cosine domain (their per-tile scales make raw scores incomparable
        across tiles) and merges them into the (Q, k) carry."""
        if normalize:
            block = l2_normalize(block.float()).to(block.dtype)
        if use_pallas:
            return topk_local(queries, block, k, n_valid)
        # int8 and bf16 operands upcast: exact products, f32 sums
        sc = queries.float() @ block.float().T
        col = torch.arange(block.shape[0], device=block.device)
        sc = torch.where(col[None, :] < n_valid, sc, float("-inf"))
        return _local_topk(sc, min(k, block.shape[0]))

    def search_ids(self, queries, k: int = 10, score: str = "cos_sim"):
        """→ (scores, doc-id lists) with the external ids when given."""
        s, i = self.search(queries, k, score)
        ids = self.ids if self.ids is not None else range(self.n_docs)
        return s, [[ids[j] for j in row] for row in i]
