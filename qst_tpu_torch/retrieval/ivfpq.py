"""IVF-PQ index — counterpart of ``qst_tpu/retrieval/ivfpq.py``.

Inverted cells whose entries are PQ codes: m bytes a doc on the device, as
``PQIndex``, but a search decodes only the ``n_probe`` probed cells of each
query.

- **Coarse quantizer**: the IVF slice's spherical k-means, choice-table
  assignment and budgeted fill with spill (``retrieval/ivf.py``:
  ``kmeans``, ``_assign_choices``, ``_fill_cells``).
- **Fine quantizer**: per-subspace PQ codebooks (``pq_lloyd``), by default
  on **residuals** r = x − c_cell, so the same bytes quantize finer; scores
  recombine as q·x̂ = q·c_cell + q·r̂, the first term from the probe
  selection's product. ``bits=4`` packs two 16-way subspaces a byte
  (``retrieval/pq4.py``): 2m subspaces at m bytes a doc.
- **Search** scans the probes with a running top-k (``_probe_scan``): each
  step gathers the probed cells' codes (Q, L, m), decodes them to a
  (Q, L, D) reconstruction and scores one batched product. This is plain
  PyTorch, as it is plain XLA in the JAX package (no ``pallas_call``); the
  decode is a gather from the codebooks (the JAX package's one-hot product
  gives the same bits), in the device's compute dtype (bf16 on a GPU,
  products summed in f32).
- Optional **exact re-rank** from host rows (``keep_rows`` /
  ``refine_factor``, ``PQIndex``'s contract and ``refine_pair``).

The k-means init, the training sample and the codebooks' initial centroids
are drawn from a ``torch.Generator``: a built index is statistically, not
bitwise, the JAX one; ``from_arrays`` carries a JAX-built index across
exactly.

**A mesh** (``mesh=``, ``core/meshes.py``) splits the cell tensors, padded
to a multiple of the shard count (ids −1), ``cells_per_shard`` a shard: the
probe list is computed once from the replicated centroids, each shard scans
the probed cells it owns through the source's masked clamp-gather, and the
candidates merge in shard order (``core/meshes.py:merge_topk``).
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from qst_tpu_torch.core.device import device_of
from qst_tpu_torch.core.meshes import (
    RowShards,
    as_mesh,
    gathered,
    merge_topk,
    replicate,
    shard_loop,
    sharded,
)
from qst_tpu_torch.ops.distances import l2_normalize
from qst_tpu_torch.retrieval.ivf import (
    _assign_choices,
    _fill_cells,
    _tensor,
    kmeans,
    row_reader,
    sample_rows,
)
from qst_tpu_torch.retrieval.pq import (
    K_CENTROIDS,
    PQ_TILE,
    _adopt_refine_rows,
    _aniso_fit,
    _compute_dtype,
    _decode_rows,
    _merge_topk,
    _refine_rows_f32,
    _refine_rows_of,
    _refine_table,
    pq_lloyd,
    refine_pair,
)
from qst_tpu_torch.retrieval.pq4 import (
    K4,
    block_codebooks,
    decode4_gather,
    decode4_rows,
    pq4_encode,
    pq4_train,
    validate_pq4_dims,
)


def pq_train_raw(sample: torch.Tensor, generator: torch.Generator, m: int,
                 n_iters: int = 12, init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-subspace 256-way Lloyd k-means without input normalization (the
    residual-space twin of ``pq_train``) → (m, 256, ds) f32."""
    s, d = sample.shape
    xs = sample.float().reshape(s, m, d // m).transpose(0, 1)
    if init is None:
        idx = torch.randperm(s, generator=generator)[:K_CENTROIDS].to(xs.device)
        init = xs[:, idx, :]
    return pq_lloyd(xs, init, n_iters)


def pq_encode_raw(vectors: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Encode raw (non-normalized) vectors → (B, m) uint8."""
    m, _, ds = codebooks.shape
    xs = vectors.float().reshape(vectors.shape[0], m, ds).transpose(0, 1)
    return torch.argmax(_aniso_fit(xs, codebooks.float(), 0.0), dim=-1).T.to(torch.uint8)


def _decode_any(codes_flat: torch.Tensor, cb: torch.Tensor, bits: int,
                decode: str = "gather") -> torch.Tensor:
    """(T, m) uint8 codes → (T, D) in ``cb``'s dtype. ``cb`` is the (m, 256,
    ds) codebooks for bits = 8 and the (2m, 16, ds) ones for bits = 4;
    ``decode="onehot"`` runs the JAX package's one-hot products (the
    block-diagonal one for 4 bits), ``"gather"`` the same bits by gathers."""
    if bits == 8:
        return _decode_rows(codes_flat, cb, decode)
    if decode == "gather":
        return decode4_gather(codes_flat, cb)
    blk = block_codebooks(cb)
    return torch.cat([decode4_rows(codes_flat[lo:lo + PQ_TILE], blk)
                      for lo in range(0, codes_flat.shape[0], PQ_TILE)])


def _probe_scan(qc: torch.Tensor, psim: torch.Tensor, probe: torch.Tensor, gather: Callable,
                cb: torch.Tensor, bits: int, residual: bool, k: int, L: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-probe scan: for each probe column, ``gather(cell ids) ->
    ((Q, L, m) codes, (Q, L) ids)`` fetches the cells, the codes decode
    (``cb`` already in the scoring dtype), scores add the residual's
    centroid term ``psim`` and a running top-k folds the cell in."""
    Q = qc.shape[0]
    n_probe = probe.shape[1]
    kk = min(k, L)
    kc = min(k, n_probe * L)
    cs = torch.full((Q, kc), float("-inf"), device=qc.device)
    ci = torch.full((Q, kc), -1, dtype=torch.int64, device=qc.device)
    for p in range(n_probe):
        codes, ids = gather(probe[:, p])                          # (Q, L, m), (Q, L)
        recon = _decode_any(codes.reshape(Q * L, -1), cb, bits).reshape(Q, L, -1)
        s = torch.einsum("qd,qld->ql", qc, recon)
        if residual:
            s = s + psim[:, p][:, None]
        s = torch.where(ids >= 0, s, float("-inf"))
        s1, pos = torch.topk(s, kk, dim=1)
        cs, ci = _merge_topk(cs, ci, s1, torch.gather(ids, 1, pos), kc)
    return cs, ci


def _probe_queries(queries: torch.Tensor, centroids: torch.Tensor, codebooks: torch.Tensor,
                   n_probe: int):
    """→ (queries, codebooks) rounded to the compute dtype (bf16 on a GPU)
    and held in f32, and the (Q, P) f32 centroid products and cell ids of
    each query's probes."""
    qf = l2_normalize(queries.float())
    psim, probe = torch.topk(qf @ centroids.T, n_probe, dim=1)    # (Q, P) × 2
    cd = _compute_dtype(queries.device)
    return qf.to(cd).float(), codebooks.to(cd).float(), psim, probe


def _ivfpq_search(queries: torch.Tensor, centroids: torch.Tensor, cell_codes: torch.Tensor,
                  cell_ids: torch.Tensor, codebooks: torch.Tensor, n_probe: int, k: int,
                  residual: bool, bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """queries (Q, D); cell_codes (C, L, m) uint8 (packed nibble pairs for
    bits = 4); cell_ids (C, L) (−1 = padding) → (scores (Q, kc) f32, doc
    positions (Q, kc) int64). Queries and decoded rows are rounded to the
    compute dtype (bf16 on a GPU) and scored in f32; the centroid term is
    f32."""
    qc, cb, psim, probe = _probe_queries(queries, centroids, codebooks, n_probe)
    return _probe_scan(qc, psim, probe, lambda pid: (cell_codes[pid], cell_ids[pid].long()),
                       cb, bits, residual, k, cell_codes.shape[1])


class IncrementalCellFill:
    """Host-side budgeted cell fill for chunked builds (corpora generated
    or streamed chunk by chunk): ``_fill_cells``' round-based spill policy
    applied incrementally — each chunk's docs take their best remaining
    choice, ranked stably within a cell, spilling to later choices when the
    running fill reaches the budget."""

    def __init__(self, n_clusters: int, budget: int):
        self.fill = np.zeros(n_clusters, np.int64)
        self.budget = int(budget)
        self.spilled = 0

    def place(self, choices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(B, R) best-first cell choices → (cell (B,), slot (B,)) int64.
        Raises if any doc exhausts its R choices (budget too small)."""
        choices = np.asarray(choices)
        B, R = choices.shape
        cell = np.full(B, -1, np.int64)
        slot = np.full(B, -1, np.int64)
        un = np.arange(B)
        for r in range(R):
            if not len(un):
                break
            cand = choices[un, r].astype(np.int64)
            order = np.argsort(cand, kind="stable")
            sc = cand[order]
            # rank within each equal-cell run
            starts = np.r_[0, np.nonzero(np.diff(sc))[0] + 1]
            run_len = np.diff(np.r_[starts, len(sc)])
            rank = np.arange(len(sc)) - np.repeat(starts, run_len)
            pos = self.fill[sc] + rank
            ok = pos < self.budget
            placed = un[order[ok]]
            cell[placed] = sc[ok]
            slot[placed] = pos[ok]
            self.fill += np.bincount(sc[ok], minlength=len(self.fill))
            if r > 0:
                self.spilled += int(ok.sum())
            un = un[order[~ok]]
        if len(un):
            raise ValueError(
                f"{len(un)} docs exhausted their {R} cell choices — "
                f"raise cell_budget or spill_rounds")
        return cell, slot


def _check_codebooks(codebooks: torch.Tensor, m: int, d: int, bits: int) -> None:
    want = (2 * m, K4, d // (2 * m)) if bits == 4 else (m, K_CENTROIDS, d // m)
    if tuple(codebooks.shape) != want:
        raise ValueError(f"codebooks shape {tuple(codebooks.shape)} != {want}")


class IVFPQIndex:
    """Approximate cosine index: k-means cells holding PQ codes.

    m bytes a doc on the device like ``PQIndex``, but a search decodes only
    the ``n_probe`` probed cells of each query. ``residual=True`` (default)
    encodes x − c_cell. ``keep_rows`` keeps the unit-normalized originals in
    host memory for ``refine_factor`` re-ranking (True/"bfloat16" or
    "int8", as ``PQIndex``). The index lives on ``device`` (default: a
    tensor's own device; host arrays go to the GPU)."""

    DEFAULT_REFINE = 8
    # the gathered codes and the (Q, L, D) reconstruction of one probe step
    # peak at Q·L·(m + 2·D) bytes: the per-dispatch query chunk bounds it
    RECON_BUDGET_BYTES = 1 << 29

    def __init__(self, embeddings, n_clusters: int = 256, m: int = 48,
                 ids: Optional[list] = None, n_iters: int = 10, pq_iters: int = 12,
                 cell_budget: Optional[int] = None, seed: int = 0,
                 train_sample: int = 262144, spill_rounds: int = 4, mesh: Any = None,
                 assign_chunk: int = 1 << 20, encode_chunk: int = 1 << 16,
                 default_n_probe: int = 8, residual: bool = True, keep_rows=False,
                 bits: int = 8, device: Any = None):
        mesh = as_mesh(mesh)
        if mesh is not None and device is None:
            device = mesh.home
        self.device = device_of(embeddings, device)
        emb = embeddings if isinstance(embeddings, torch.Tensor) else np.asarray(embeddings)
        n, d = emb.shape
        if n_clusters >= n:
            raise ValueError("n_clusters must be < number of docs")
        if bits not in (4, 8):
            raise ValueError(f"bits must be 4 or 8, got {bits}")
        if m % 8 != 0:
            raise ValueError(f"m must be a multiple of 8, got {m}")
        if bits == 4:
            # m stays bytes a doc: 2m nibble subspaces of d/(2m) dims
            validate_pq4_dims(d, 2 * m)
        elif d % m != 0:
            raise ValueError(f"dim {d} not divisible by m={m}")
        if n < (K4 if bits == 4 else K_CENTROIDS):
            raise ValueError(f"need >= {K4 if bits == 4 else K_CENTROIDS} docs to "
                             f"train PQ codebooks (got {n})")
        if n > train_sample and n_clusters > train_sample:
            raise ValueError(f"n_clusters={n_clusters} exceeds train_sample={train_sample}")
        self.m, self.dim, self.n_docs = m, d, n
        self.bits = bits
        self.residual = bool(residual)
        self.default_n_probe = default_n_probe
        self.ids = list(ids) if ids is not None else list(range(n))
        if len(self.ids) != n:
            raise ValueError("ids length mismatch")
        rows = row_reader(emb, self.device)

        # 1) coarse quantizer on a sample; 2) fine quantizer on the same
        #    sample (residual space by default)
        gen = torch.Generator().manual_seed(seed)
        sample = sample_rows(n, train_sample, rows, gen)
        self.centroids, sample_assign = kmeans(sample, gen, n_clusters, n_iters)
        sample_n = l2_normalize(sample.float())
        train_vecs = sample_n - self.centroids[sample_assign] if self.residual else sample_n
        if bits == 4:
            self.codebooks = pq4_train(train_vecs, gen, 2 * m, pq_iters)
        else:
            self.codebooks = pq_train_raw(train_vecs, gen, m, pq_iters)
        del sample, sample_n, train_vecs

        # 3) chunked full-corpus assignment: only the (N, R) choice table
        #    reaches the host
        n_choices = min(spill_rounds, n_clusters)
        assign_chunk = min(assign_chunk, max(8192, (1 << 30) // (4 * n_clusters)))
        choices = np.empty((n, n_choices), np.int32)
        for lo in range(0, n, assign_chunk):
            hi = min(lo + assign_chunk, n)
            choices[lo:hi] = _assign_choices(rows(slice(lo, hi)), self.centroids,
                                             n_choices).cpu().numpy()

        # 4) budget + budgeted fill with spill
        counts = np.bincount(choices[:, 0], minlength=n_clusters)
        if cell_budget is None:
            cell_budget = max(128, int(np.quantile(counts[counts > 0], 0.95)))
            cell_budget = ((cell_budget + 127) // 128) * 128
        else:
            cell_budget = ((cell_budget + 7) // 8) * 8
        L = cell_budget
        cell, slot, self.spilled = _fill_cells(choices, n_clusters, L)
        del choices
        self.fill = torch.from_numpy(
            np.bincount(cell, minlength=n_clusters).astype(np.int32)).to(self.device)

        # 5) chunked encode, codes scattered into the cells on the device
        self._refine_rows, self._refine_scale = _refine_table(keep_rows, n, d)
        flat_pos = cell * L + slot
        cell_dev = torch.from_numpy(cell).to(self.device)
        codes = torch.zeros((n_clusters * L, m), dtype=torch.uint8, device=self.device)
        for lo in range(0, n, encode_chunk):
            hi = min(lo + encode_chunk, n)
            rows_n = l2_normalize(rows(slice(lo, hi)).float())
            enc_in = rows_n - self.centroids[cell_dev[lo:hi]] if self.residual else rows_n
            codes.index_copy_(0, torch.from_numpy(flat_pos[lo:hi]).to(self.device),
                              pq4_encode(enc_in, self.codebooks) if bits == 4
                              else pq_encode_raw(enc_in, self.codebooks))
            if self._refine_rows is not None:
                self._refine_rows[lo:hi] = _refine_rows_of(rows_n, self._refine_scale)
        cell_ids = np.full((n_clusters * L,), -1, np.int32)
        cell_ids[flat_pos] = np.arange(n, dtype=np.int32)
        self.cell_budget = L
        self._install_cells(codes.view(n_clusters, L, m),
                            torch.from_numpy(cell_ids.reshape(n_clusters, L)).to(self.device),
                            mesh)

    def _install_cells(self, cell_codes: torch.Tensor, cell_ids: torch.Tensor, mesh) -> None:
        """Place the cell tensors on the index's device — split over the
        mesh when given: padded to a multiple of the shard count (codes 0,
        ids −1), ``cells_per_shard`` cells a shard, as :class:`RowShards`
        (``gathered`` reads them whole)."""
        self.mesh = sharded(mesh)
        if self.mesh is None:
            self.cell_codes, self.cell_ids = cell_codes, cell_ids
            return
        C = cell_codes.shape[0]
        cps = self.cells_per_shard = -(-C // self.mesh.size)
        pad = cps * self.mesh.size - C
        self.cell_codes = RowShards(torch.nn.functional.pad(
            cell_codes, (0, 0, 0, 0, 0, pad)).to(self.device), self.mesh, cps)
        self.cell_ids = RowShards(torch.nn.functional.pad(
            cell_ids, (0, 0, 0, pad), value=-1).to(self.device), self.mesh, cps)

    @classmethod
    def from_arrays(cls, centroids, cell_codes, cell_ids, codebooks, fill,
                    ids: Optional[list] = None, mesh: Any = None, default_n_probe: int = 8,
                    residual: bool = True, refine_rows=None, bits: int = 8,
                    device: Any = None) -> "IVFPQIndex":
        """Rebuild from persisted arrays — no k-means, no encode (the
        Retriever reload path, and how a JAX-built index is carried over).
        ``codebooks`` are the raw (m, 256, ds) ones, or (2m, 16, ds) for 4
        bits."""
        mesh = as_mesh(mesh)
        if bits not in (4, 8):
            raise ValueError(f"bits must be 4 or 8, got {bits}")
        dev = device_of(cell_codes, device if device is not None or mesh is None
                        else mesh.home)
        cell_codes = _tensor(cell_codes).to(torch.uint8)
        cell_ids = _tensor(cell_ids).to(torch.int32)
        if cell_codes.ndim != 3 or tuple(cell_ids.shape) != tuple(cell_codes.shape[:2]):
            raise ValueError(f"cell_codes {tuple(cell_codes.shape)} / cell_ids "
                             f"{tuple(cell_ids.shape)} mismatch")
        self = cls._adopt(centroids, cell_codes, cell_ids, codebooks, ids,
                          default_n_probe, residual, bits, refine_rows, dev, mesh=mesh)
        self.fill = _tensor(fill).to(torch.int32).to(dev)
        return self

    @classmethod
    def from_device_arrays(cls, centroids, cell_codes, cell_ids, codebooks, ids=None,
                           default_n_probe: int = 8, residual: bool = True, bits: int = 8,
                           refine_rows=None) -> "IVFPQIndex":
        """Adopt (C, L, m) uint8 cell codes already on a device, in place —
        the large-corpus build path: codes generated, encoded and scattered
        on the device (``IncrementalCellFill`` places them) never pass
        through the host. ``ids=None`` stores a ``range``. The fill counts
        are read off ``cell_ids``."""
        if bits not in (4, 8):
            raise ValueError(f"bits must be 4 or 8, got {bits}")
        if not (isinstance(cell_codes, torch.Tensor) and cell_codes.dtype == torch.uint8
                and cell_codes.ndim == 3):
            raise ValueError("cell_codes must be a (C, L, m) uint8 tensor — use "
                             "from_arrays for host arrays")
        cell_ids = torch.as_tensor(cell_ids).to(cell_codes.device, torch.int32)
        if tuple(cell_ids.shape) != tuple(cell_codes.shape[:2]):
            raise ValueError(f"cell_ids {tuple(cell_ids.shape)} != "
                             f"{tuple(cell_codes.shape[:2])}")
        self = cls._adopt(centroids, cell_codes, cell_ids, codebooks, ids, default_n_probe,
                          residual, bits, refine_rows, cell_codes.device, ids_range=True)
        self.fill = torch.sum(cell_ids >= 0, dim=1).to(torch.int32)
        return self

    @classmethod
    def _adopt(cls, centroids, cell_codes, cell_ids, codebooks, ids, default_n_probe,
               residual, bits, refine_rows, device, ids_range: bool = False, mesh=None):
        self = cls.__new__(cls)
        self.device = torch.device(device)
        self.centroids = _tensor(centroids).float().to(self.device)
        self.codebooks = _tensor(codebooks).float().to(self.device)
        C, L, m = cell_codes.shape
        d = int(self.centroids.shape[1])
        _check_codebooks(self.codebooks, m, d, bits)
        self.m, self.dim, self.bits = m, d, bits
        self.residual = bool(residual)
        self.default_n_probe = default_n_probe
        n = int((cell_ids >= 0).sum())
        self.n_docs = n
        self.cell_budget = L
        self.spilled = 0
        self.ids = list(ids) if ids is not None else (range(n) if ids_range
                                                      else list(range(n)))
        if len(self.ids) != n:
            raise ValueError("ids length mismatch")
        self._refine_rows, self._refine_scale = _adopt_refine_rows(refine_rows, n, d)
        self._install_cells(cell_codes.to(self.device), cell_ids.to(self.device), mesh)
        return self

    def bytes_per_doc(self) -> int:
        return self.m

    def refine_rows_f32(self) -> Optional[np.ndarray]:
        return _refine_rows_f32(self._refine_rows, self._refine_scale)

    def reconstruct_rows(self) -> np.ndarray:
        """→ (n_docs, D) f32 host matrix of the PQ reconstructions in id
        order (centroid + decoded residual when ``residual``): the golden of
        the full probe."""
        codes, flat_ids = gathered(self.cell_codes), gathered(self.cell_ids)
        C, L, m = codes.shape
        codes, flat_ids = codes.reshape(C * L, m), flat_ids.reshape(-1)
        out = np.empty((self.n_docs, self.dim), np.float32)
        chunk = 1 << 16
        for lo in range(0, C * L, chunk):
            hi = min(lo + chunk, C * L)
            ids = flat_ids[lo:hi]
            valid = ids >= 0
            if not bool(valid.any()):
                continue
            dec = _decode_any(codes[lo:hi], self.codebooks, self.bits)
            if self.residual:
                # clamped: a mesh pads cells past the centroids (their ids are −1)
                cell = (torch.arange(lo, hi, device=self.device) // L).clamp_max(
                    self.centroids.shape[0] - 1)
                dec = dec + self.centroids[cell]
            out[ids[valid].cpu().numpy()] = dec[valid].cpu().numpy()
        return out

    def _queries(self, queries) -> torch.Tensor:
        return torch.as_tensor(queries, device=self.device).float()

    def _device_search(self, q: torch.Tensor, k: int, n_probe: int):
        if self.mesh is None:
            return _ivfpq_search(q, self.centroids, self.cell_codes, self.cell_ids,
                                 self.codebooks, n_probe, k, self.residual, self.bits)
        qc, cb, psim, probe = _probe_queries(q, self.centroids, self.codebooks, n_probe)
        cps, L = self.cells_per_shard, self.cell_budget
        qs, cbs = replicate(qc, self.mesh), replicate(cb, self.mesh)
        sims, probes = replicate(psim, self.mesh), replicate(probe, self.mesh)
        codes, ids = self.cell_codes.blocks, self.cell_ids.blocks

        def shard(i: int, dev):
            def gather(col):         # the source's masked clamp-gather
                pid = col - i * cps
                c = pid.clamp(0, cps - 1)
                owned = (pid >= 0) & (pid < cps)
                return codes[i][c], torch.where(owned[:, None], ids[i][c].long(), -1)
            return _probe_scan(qs[dev], sims[dev], probes[dev], gather, cbs[dev], self.bits,
                               self.residual, k, L)

        return merge_topk(shard_loop(self.mesh, shard), min(k, n_probe * L), self.device)

    def _device_search_retriever(self, q, k: int, score: str = "cos_sim", tile: int = 0,
                                 backend: str = "auto"):
        """The Retriever's single-dispatch contract (``ExactIndex``'s
        positional shape) at the index's default_n_probe."""
        if score not in ("cos_sim", "dot_score"):
            raise ValueError("IVF-PQ index supports cos_sim/dot_score only "
                             "(rows are normalized at encode time)")
        return self._device_search(self._queries(q), min(k, self.n_docs),
                                   min(self.default_n_probe, int(self.centroids.shape[0])))

    def _q_chunk(self) -> int:
        row = self.cell_budget * (self.m + 2 * self.dim)
        return max(8, min(4096, self.RECON_BUDGET_BYTES // row))

    def search(self, queries, k: int = 10, n_probe: Optional[int] = None,
               refine_factor: Optional[int] = None,
               score: str = "cos_sim") -> Tuple[np.ndarray, List[list]]:
        """→ (scores, per-query external-id lists); the width is
        ``min(k, n_probe · cell_budget)``. ``refine_factor=r`` re-ranks the
        top r·k candidates exactly from the host rows (needs ``keep_rows``);
        default: DEFAULT_REFINE when refine rows exist, else 0."""
        if score not in ("cos_sim", "dot_score"):
            raise ValueError("IVF-PQ index supports cos_sim/dot_score only "
                             "(rows are normalized at encode time)")
        n_probe = min(n_probe or self.default_n_probe, int(self.centroids.shape[0]))
        if refine_factor is None:
            refine_factor = self.DEFAULT_REFINE if self._refine_rows is not None else 0
        if refine_factor and self._refine_rows is None:
            raise ValueError("refine_factor needs keep_rows=True at build time")
        k = min(k, self.n_docs)
        kk = min(k * refine_factor, self.n_docs) if refine_factor else k
        q = self._queries(queries)
        chunk = self._q_chunk()
        outs = [self._device_search(q[lo:lo + chunk], kk, n_probe)
                for lo in range(0, q.shape[0], chunk)]
        s = torch.cat([o[0] for o in outs]).cpu().numpy()
        i = torch.cat([o[1] for o in outs]).cpu().numpy()
        if refine_factor:
            # the probed pool may hold fewer than k at tiny n_probe · L
            s, i = refine_pair(q, self._refine_rows, i, min(k, i.shape[1]),
                               self._refine_scale, self.n_docs)
        return s, [[self.ids[j] if j >= 0 else None for j in row] for row in i]

    def search_ids(self, queries, k: int = 10, n_probe: Optional[int] = None,
                   refine_factor: Optional[int] = None, score: str = "cos_sim"):
        """Alias of :meth:`search` (ids are its native return)."""
        return self.search(queries, k, n_probe, refine_factor, score)

    def search_stream(self, query_batches, k: int = 10, n_probe: Optional[int] = None,
                      depth: int = 4, refine_factor: Optional[int] = None):
        """Pipelined serving loop: yields ``(scores, positions)`` numpy pairs
        in input order with up to ``depth`` searches queued on the device;
        a batch is refined as it is taken off the queue."""
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        n_probe = min(n_probe or self.default_n_probe, int(self.centroids.shape[0]))
        refine = refine_factor or 0
        if refine and self._refine_rows is None:
            raise ValueError("refine_factor needs keep_rows=True at build time")

        def finish(q, s, i):
            s, i = s.cpu().numpy(), i.cpu().numpy()
            if not refine:
                return s, i
            return refine_pair(q, self._refine_rows, i, min(k, i.shape[1]),
                               self._refine_scale, self.n_docs)

        kk = min(k * refine, self.n_docs) if refine else min(k, self.n_docs)
        pending: list = []
        for q in query_batches:
            q = self._queries(q)
            pending.append((q, *self._device_search(q, kk, n_probe)))
            if len(pending) >= depth:
                yield finish(*pending.pop(0))
        while pending:
            yield finish(*pending.pop(0))

    def tune_n_probe(self, queries, k: int = 10, target_recall: float = 0.95,
                     candidates: Optional[List[int]] = None,
                     set_default: bool = True) -> Tuple[int, dict]:
        """Pick the smallest ``n_probe`` meeting a recall target against this
        index's own full probe (exact with respect to the reconstructions);
        the contract of ``IVFIndex.tune_n_probe``."""
        if not 0.0 < target_recall <= 1.0:
            raise ValueError(f"target_recall must be in (0, 1], got {target_recall}")
        n_cells = int(self.centroids.shape[0])
        if candidates is None:
            candidates = []
            p = 1
            while p < n_cells:
                candidates.append(p)
                p *= 2
        else:
            given = list(candidates)
            candidates = sorted({int(p) for p in given if 1 <= int(p) < n_cells})
            if not candidates:
                raise ValueError(
                    f"no candidates in [1, {n_cells}) after filtering "
                    f"{given!r}; pass n_probe values below the cell count")
        k = min(k, self.n_docs)
        q = np.asarray(queries.cpu() if isinstance(queries, torch.Tensor) else queries,
                       np.float32)
        if q.ndim != 2 or q.shape[0] == 0:
            raise ValueError(f"queries must be a non-empty (Q, D) sample, got {q.shape}")
        _, truth = self.search(q, k=k, n_probe=n_cells, refine_factor=0)
        truth_sets = [set(i for i in row if i is not None) for row in truth]
        curve: dict = {}
        best = n_cells
        for p in candidates:
            _, got = self.search(q, k=k, n_probe=p, refine_factor=0)
            recall = float(np.mean([
                len(t & {i for i in row if i is not None}) / max(len(t), 1)
                for t, row in zip(truth_sets, got)]))
            curve[p] = recall
            if recall >= target_recall:
                best = p
                break
        if best == n_cells:
            curve[n_cells] = 1.0
            warnings.warn(
                f"tune_n_probe: no candidate in {candidates} reached "
                f"recall@{k} >= {target_recall}; "
                + ("installing" if set_default else "returning")
                + f" the exhaustive full probe (n_probe={n_cells})", stacklevel=2)
        if set_default:
            self.default_n_probe = best
        return best, curve
