"""IVF (inverted-file) approximate index — counterpart of
``qst_tpu/retrieval/ivf.py``.

k-means partitions the corpus into ``n_clusters`` cells and a query scores
only the documents of its ``n_probe`` closest cells:

- **k-means trains on a sample** (``train_sample`` docs): Lloyd iterations
  of one cosine product + argmax and one segment sum (``lloyd``);
- **full-corpus assignment is chunked on the device**: each chunk is one
  product + a top-R choice list; only the (N, R) int32 choice table reaches
  the host;
- **cell fill is vectorized on the host** (``_fill_cells``, a numpy copy of
  the source): docs overflowing their first cell's budget spill to their
  next-best cell, so nothing is dropped;
- **cells are scattered on the device** into one (C, L, D) padded tensor,
  float32 or bfloat16, chunk by chunk in place;
- **search** has the source's two backends: ``"xla"`` scans the probes with
  a running top-k (one (Q, L, D) gather at a time), ``"pallas"`` scores all
  probed cells with K6 (``ops/ivf.py``: the CUDA kernel on a GPU index, its
  plain version on a CPU index), which is handed the per-cell fill counts
  and scores padded slots −inf without reading them, and takes one bucketed
  top-k over the (Q, P·L) scores. ``"auto"`` takes K6 under the source's
  rule (cell budget a multiple of 128) with "the index's device is not the
  CPU" in place of "the platform is not cpu".

**A mesh** (``mesh=``, ``core/meshes.py``) splits the cells: padded to a
multiple of the shard count (ids −1), ``cells_per_shard`` a shard. The
probe list is computed once from the replicated centroids; each shard
scans the probed cells it owns — on the K6 path K6 over its probes, a probe
that another shard owns pointed at a sentinel cell whose fill is 0 (on the
card it scores −inf without a read), on the scan path the masked
clamp-gather of the source — and the candidates merge in shard order
(``core/meshes.py:merge_topk``).

What differs from the source: the k-means init and the training sample come
from a ``torch.Generator`` (``jax.random.choice`` has no torch twin), so a
built index is statistically, not bitwise, the JAX one — ``from_arrays``
carries a JAX-built index across exactly. The donation and ``block_until_ready`` barriers of the build
and ``compact``'s sleep-and-retry loops served a TPU dev relay and are not
carried.
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
from qst_tpu_torch.ops.ivf import ivf_cell_scores
from qst_tpu_torch.retrieval.index import _local_topk

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tensor(x) -> torch.Tensor:
    """A tensor over host data (a read-only numpy array is copied: torch
    tensors cannot share memory they may not write)."""
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = x.copy()
    return torch.as_tensor(x)


def row_reader(emb, device: torch.device) -> Callable:
    """``rows(sel)``: rows of a corpus (a tensor on any device, or a host
    array such as a memmap, read only where selected) on ``device``, f32
    for a host array."""
    def rows(sel) -> torch.Tensor:
        if isinstance(emb, torch.Tensor):
            if not isinstance(sel, slice):
                sel = torch.as_tensor(sel, device=emb.device)
            return emb[sel].to(device)
        return _tensor(np.asarray(emb[sel], np.float32)).to(device)
    return rows


def sample_rows(n: int, train_sample: int, rows: Callable,
                gen: torch.Generator) -> torch.Tensor:
    """``train_sample`` distinct rows drawn with ``gen`` (in row order), or
    all n rows when there are no more."""
    if n <= train_sample:
        return rows(slice(None))
    return rows(np.sort(torch.randperm(n, generator=gen)[:train_sample].numpy()))


def _product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b.T with f32 accumulation whatever the operands' dtype: bf16
    operands are upcast first (exact products, f32 sums)."""
    return a.float() @ b.float().T


def lloyd(x: torch.Tensor, centroids: torch.Tensor, n_iters: int = 10,
          compute_dtype: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Lloyd loop of spherical k-means from given initial centroids:
    ``x`` (N, D) unit-norm f32, ``centroids`` (C, D) → (centroids (C, D) f32
    unit-norm, assignment (N,)). ``compute_dtype="bfloat16"`` rounds both
    products' operands to bf16 (sums stay f32); centroids stay f32."""
    cd = _DTYPES[compute_dtype] if compute_dtype else torch.float32
    n_clusters = centroids.shape[0]
    xc = x.to(cd)
    xs = xc.float()
    for _ in range(n_iters):
        assign = torch.argmax(_product(xc, centroids.to(cd)), dim=1)
        sums = torch.zeros_like(centroids, dtype=torch.float32).index_add_(0, assign, xs)
        counts = torch.bincount(assign, minlength=n_clusters).float()[:, None]
        centroids = l2_normalize(
            torch.where(counts > 0, sums / counts.clamp_min(1), centroids))
    assign = torch.argmax(_product(xc, centroids.to(cd)), dim=1)
    return centroids, assign


def kmeans(data: torch.Tensor, generator: torch.Generator, n_clusters: int,
           n_iters: int = 10, compute_dtype: Optional[str] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spherical k-means (cosine): → (centroids (C, D), assignment (N,)).
    The initial centroids are ``n_clusters`` distinct rows drawn with
    ``generator`` (a CPU generator)."""
    x = l2_normalize(data.float())
    init_idx = torch.randperm(x.shape[0], generator=generator)[:n_clusters]
    return lloyd(x, x[init_idx.to(x.device)], n_iters, compute_dtype)


def _assign_choices(emb_chunk: torch.Tensor, centroids: torch.Tensor,
                    n_choices: int) -> torch.Tensor:
    """→ (B, n_choices) int32: each doc's closest cells, best first. A bf16
    corpus is scored with bf16 operands (f32 sums), as in the source."""
    x = l2_normalize(emb_chunk.float())
    if emb_chunk.dtype == torch.bfloat16:
        x = x.to(torch.bfloat16)
    sim = _product(x, centroids.to(x.dtype))
    return torch.topk(sim, n_choices, dim=1).indices.to(torch.int32)


def _fill_cells(choices: np.ndarray, n_clusters: int, budget: int
                ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Vectorized budgeted cell fill. ``choices`` is the (N, R) host choice
    table; → (cell (N,), slot (N,), spilled). Round r places every
    still-unplaced doc into its r-th choice if capacity remains, using a
    stable argsort to rank docs within a cell — O(N log N) per round, no
    per-doc loop. Docs unplaced after R rounds raise (budget too small)."""
    n, n_rounds = choices.shape
    fill = np.zeros(n_clusters, np.int64)
    cell = np.full(n, -1, np.int64)
    slot = np.full(n, -1, np.int64)
    remaining = np.arange(n)
    for r in range(n_rounds):
        if remaining.size == 0:
            break
        choice = choices[remaining, r].astype(np.int64)
        order = np.argsort(choice, kind="stable")
        docs = remaining[order]
        cs = choice[order]
        start = np.searchsorted(cs, np.arange(n_clusters))
        rank = np.arange(cs.size) - start[cs]
        ok = rank < (budget - fill)[cs]
        placed = docs[ok]
        cell[placed] = cs[ok]
        slot[placed] = fill[cs[ok]] + rank[ok]
        fill += np.bincount(cs[ok], minlength=n_clusters)
        remaining = docs[~ok]
    if remaining.size:
        # guaranteed-placement pass: any cell with free capacity (the
        # budget is a high quantile of cell sizes, so total capacity
        # C·budget exceeds N — a handful of stragglers whose top-R choices
        # all filled land in arbitrary cells rather than aborting a
        # multi-million-doc build; recall impact is O(stragglers/N))
        caps = budget - fill
        if caps.sum() < remaining.size:
            raise RuntimeError(
                f"cell budget exhausted for {remaining.size} docs "
                f"(total free capacity {int(caps.sum())}); raise "
                f"cell_budget")
        cell_for = np.repeat(np.arange(n_clusters), caps)[: remaining.size]
        start = np.searchsorted(cell_for, np.arange(n_clusters))
        rank = np.arange(cell_for.size) - start[cell_for]
        cell[remaining] = cell_for
        slot[remaining] = fill[cell_for] + rank
    spilled = int(np.sum(cell != choices[:, 0]))
    return cell, slot, spilled


def _probe_scan(qc: torch.Tensor, probe: torch.Tensor, fetch: Callable, k: int,
                budget: int, n_probe: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scan the ``n_probe`` probed cells with a running top-k carry — peak
    memory one (Q, L, D) gather, independent of n_probe.
    ``fetch(pid_col) -> (cand (Q, L, D), ids (Q, L))`` supplies each probe
    column's cell rows + doc ids (-1 = padding, masked before any top-k)."""
    Q = qc.shape[0]
    kk = min(k, budget)            # per-cell: a cell holds only L docs
    kc = min(k, n_probe * budget)  # carry: total probed candidate pool
    cs = torch.full((Q, kc), float("-inf"), device=qc.device)
    ci = torch.full((Q, kc), -1, dtype=torch.int64, device=qc.device)
    qf = qc.float()
    for p in range(n_probe):
        cand, ids = fetch(probe[:, p])
        s = torch.einsum("qd,qld->ql", qf, cand.float())
        s = torch.where(ids >= 0, s, float("-inf"))
        s1, pos = torch.topk(s, kk, dim=1)
        i1 = torch.gather(ids, 1, pos)
        cs, pos2 = torch.topk(torch.cat([cs, s1], dim=1), kc, dim=1)
        ci = torch.gather(torch.cat([ci, i1], dim=1), 1, pos2)
    return cs, ci


def _probe(queries: torch.Tensor, centroids: torch.Tensor, n_probe: int):
    """→ (unit-norm f32 queries, (Q, P) ids of each query's closest cells, in
    any order: every probed cell is scored whatever its place). The centroid
    product is a plain matmul, as it is plain XLA in the source."""
    qf = l2_normalize(queries.float())
    return qf, torch.topk(qf @ centroids.T, n_probe, dim=1, sorted=False).indices


def _ivf_search(queries: torch.Tensor, centroids: torch.Tensor, cells: torch.Tensor,
                cell_ids: torch.Tensor, n_probe: int, k: int):
    """The ``"xla"`` backend. queries (Q, D); cells (C, L, D) padded per-cell
    doc matrix; cell_ids (C, L) global doc ids (-1 = padding)."""
    qf, probe = _probe(queries, centroids, n_probe)
    return _probe_scan(qf.to(cells.dtype), probe,
                       lambda pid: (cells[pid], cell_ids[pid].long()),
                       k, cells.shape[1], n_probe)


def _scores_to_docs(qf: torch.Tensor, probe: torch.Tensor, cells: torch.Tensor,
                    cell_ids: torch.Tensor, fill: torch.Tensor, k: int):
    """K6 over given probes → one bucketed top-k over the (Q, P·L) scores →
    doc ids, −1 where the score is −inf. K6 scores slots at or past each
    cell's fill count −inf itself (the source masks them after its kernel)."""
    L = cells.shape[1]
    scores = ivf_cell_scores(qf, cells, probe, fill)             # (Q, P·L) f32
    s, pos = _local_topk(scores, min(k, scores.shape[1]))
    # the probed cells' ids laid out as the scores are, read at the winners
    doc = cell_ids[probe].reshape(scores.shape).gather(1, pos).long()   # (Q, kc)
    return s, torch.where(torch.isneginf(s), -1, doc)


def _ivf_pallas_search(queries: torch.Tensor, centroids: torch.Tensor,
                       cells: torch.Tensor, cell_ids: torch.Tensor, fill: torch.Tensor,
                       n_probe: int, k: int):
    """The ``"pallas"`` backend (``_ivf_pallas_search_fn`` in the source):
    centroid product → probe top-k → K6 over the probed cells
    (``_scores_to_docs``)."""
    qf, probe = _probe(queries, centroids, n_probe)
    return _scores_to_docs(qf, probe, cells, cell_ids, fill, k)


class IVFIndex:
    """Approximate cosine index: k-means cells + n_probe search.

    Cells are stored as a fixed (C, L, D) padded tensor (L = per-cell budget,
    95th-percentile cell size by default); overflowing docs spill into their
    next-best cell so nothing is dropped. ``embeddings`` may be a host array
    (uploaded chunk by chunk, never whole) or a tensor; the index lives on
    ``device`` (default: a tensor's own device; host arrays go to the GPU).
    ``dtype="bfloat16"`` halves the cells' memory and gather bytes.
    ``mesh`` splits the cells over its devices (the module's docstring)."""

    def __init__(self, embeddings, n_clusters: int = 256,
                 ids: Optional[list] = None, n_iters: int = 10,
                 cell_budget: Optional[int] = None, seed: int = 0,
                 train_sample: int = 262144, spill_rounds: int = 4,
                 dtype: str = "float32", mesh: Any = None,
                 assign_chunk: int = 1 << 20, default_n_probe: int = 8,
                 device: Any = None):
        mesh = as_mesh(mesh)
        if mesh is not None and device is None:
            device = mesh.devices[0]
        self.default_n_probe = default_n_probe
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be float32|bfloat16, got {dtype}")
        self.device = device_of(embeddings, device)
        emb = embeddings if isinstance(embeddings, torch.Tensor) \
            else np.asarray(embeddings, np.float32)
        n, d = emb.shape
        if n_clusters >= n:
            raise ValueError("n_clusters must be < number of docs")
        if n > train_sample and n_clusters > train_sample:
            raise ValueError(
                f"n_clusters={n_clusters} exceeds train_sample="
                f"{train_sample}: k-means trains on the sample, which must "
                "contain at least one point per cluster — raise "
                "train_sample or lower n_clusters")
        self.ids = list(ids) if ids is not None else list(range(n))
        if len(self.ids) != n:
            raise ValueError("ids length mismatch")

        rows = row_reader(emb, self.device)

        # 1) k-means on a device-resident sample
        gen = torch.Generator().manual_seed(seed)
        sample = sample_rows(n, train_sample, rows, gen)
        self.centroids, _ = kmeans(
            sample, gen, n_clusters, n_iters,
            compute_dtype="bfloat16" if dtype == "bfloat16" else None)
        del sample

        # 2) chunked full-corpus assignment: only the (N, R) int32 choice
        #    table reaches the host. The (chunk, C) f32 similarity is the
        #    largest transient — bound it to ~1 GB
        n_choices = min(spill_rounds, n_clusters)
        assign_chunk = min(assign_chunk,
                           max(8192, (1 << 30) // (4 * n_clusters)))
        choices = np.empty((n, n_choices), np.int32)
        for lo in range(0, n, assign_chunk):
            hi = min(lo + assign_chunk, n)
            choices[lo:hi] = _assign_choices(
                rows(slice(lo, hi)), self.centroids, n_choices).cpu().numpy()

        # 3) budget from the cell-size distribution of the first choices
        counts = np.bincount(choices[:, 0], minlength=n_clusters)
        if cell_budget is None:
            # the auto budget is a multiple of 128: the bucketed top-k over
            # the (Q, P·L) scores wants 128-wide buckets
            cell_budget = max(128, int(np.quantile(counts[counts > 0],
                                                   0.95)))
            cell_budget = ((cell_budget + 127) // 128) * 128
        else:
            cell_budget = ((cell_budget + 7) // 8) * 8
        L = cell_budget

        # 4) vectorized budgeted fill + spill (host, O(N log N) per round)
        cell, slot, self.spilled = _fill_cells(choices, n_clusters, L)
        # per-cell occupancy, for masking padded slots on the K6 path
        self.fill = torch.from_numpy(
            np.bincount(cell, minlength=n_clusters).astype(np.int32)).to(self.device)

        # 5) chunked scatter into the (C, L, D) cell tensor, in place: the
        #    f32 normalize transient is one chunk, not the corpus
        #    (with a mesh the padded cells are made here, not copied later)
        flat_pos = cell * L + slot
        n_slots = self._cell_slots(n_clusters, mesh)
        cells = torch.zeros((n_slots * L, d), dtype=_DTYPES[dtype], device=self.device)
        for lo in range(0, n, assign_chunk):
            hi = min(lo + assign_chunk, n)
            pos = torch.from_numpy(flat_pos[lo:hi]).to(self.device)
            cells.index_copy_(0, pos, l2_normalize(rows(slice(lo, hi)).float()).to(cells.dtype))
        cell_ids = np.full((n_slots * L,), -1, np.int32)
        cell_ids[flat_pos] = np.arange(n, dtype=np.int32)

        self._install_cells(cells.view(n_slots, L, d),
                            torch.from_numpy(cell_ids.reshape(n_slots, L)).to(self.device),
                            mesh)
        self.n_docs = n
        self.cell_budget = L

    @staticmethod
    def _cell_slots(n_clusters: int, mesh) -> int:
        """Cells the tensors hold: n_clusters, or with a mesh the cells
        padded to a multiple of the shard count plus one sentinel cell."""
        mesh = sharded(mesh)
        return n_clusters if mesh is None else -(-n_clusters // mesh.size) * mesh.size + 1

    def _install_cells(self, cells: torch.Tensor, cell_ids: torch.Tensor, mesh) -> None:
        """Place the cell tensors (on the index's device, already holding
        ``_cell_slots`` cells) — split over the mesh when given: shard i
        holds cells [i·cps, (i+1)·cps) and addresses one cell past them as
        its sentinel, whose fill count in the shard's own fill vector is 0.
        ``self.cells`` / ``self.cell_ids`` are then :class:`RowShards`
        (``gathered`` reads them whole); ``self.fill`` stays the (C,) counts
        of the real cells."""
        self.mesh = sharded(mesh)
        if self.mesh is None:
            self.cells, self.cell_ids = cells.contiguous(), cell_ids.contiguous()
            return
        n_clusters = int(self.fill.shape[0])
        cps = self.cells_per_shard = -(-n_clusters // self.mesh.size)
        self.cells = RowShards(cells.contiguous(), self.mesh, cps, extra=1)
        self.cell_ids = RowShards(cell_ids.contiguous(), self.mesh, cps, extra=1)
        fill = torch.nn.functional.pad(self.fill, (0, cps * self.mesh.size - n_clusters))
        zero = fill.new_zeros(1)
        self._shard_fill = [torch.cat([fill[i * cps:(i + 1) * cps], zero]).to(d)
                            for i, d in enumerate(self.mesh.devices)]

    @classmethod
    def from_arrays(cls, centroids, cells, cell_ids, fill,
                    ids: Optional[list] = None, mesh: Any = None,
                    default_n_probe: int = 8, dtype: Optional[str] = None,
                    device: Any = None) -> "IVFIndex":
        """Rebuild from persisted arrays — no k-means, no assignment (the
        Retriever reload path, and how a JAX-built index is carried over).
        ``cells`` is the (C, L, D) padded cell tensor, ``cell_ids`` (C, L)
        int32 with -1 padding, ``fill`` (C,) per-cell occupancy. numpy has
        no bfloat16: bf16 cells arrive as f32 with ``dtype="bfloat16"`` (the
        re-cast is exact)."""
        mesh = as_mesh(mesh)
        if mesh is not None and device is None:
            device = mesh.devices[0]
        if dtype is not None and dtype not in _DTYPES:
            raise ValueError(f"dtype must be float32|bfloat16, got {dtype}")
        self = cls.__new__(cls)
        self.default_n_probe = default_n_probe
        self.device = device_of(cells, device)
        cells = _tensor(cells)
        cell_ids = _tensor(cell_ids).to(torch.int32)
        if cells.ndim != 3 or tuple(cell_ids.shape) != tuple(cells.shape[:2]):
            raise ValueError(
                f"cells {tuple(cells.shape)} / cell_ids {tuple(cell_ids.shape)} mismatch")
        if dtype is None and cells.dtype not in _DTYPES.values():
            dtype = "float32"
        self.centroids = _tensor(centroids).float().to(self.device)
        self.fill = _tensor(fill).to(torch.int32).to(self.device)
        n = int((cell_ids >= 0).sum())
        self.ids = list(ids) if ids is not None else list(range(n))
        if len(self.ids) != n:
            raise ValueError("ids length mismatch")
        self.spilled = 0
        self.n_docs = n
        self.cell_budget = int(cells.shape[1])
        self._install_padded(cells.to(dtype=_DTYPES[dtype] if dtype else cells.dtype),
                             cell_ids, mesh)
        return self

    def _install_padded(self, cells: torch.Tensor, cell_ids: torch.Tensor, mesh) -> None:
        """``_install_cells`` from (C, L, D) / (C, L) tensors of the real
        cells (host tensors are padded before they move)."""
        pad = self._cell_slots(cells.shape[0], mesh) - cells.shape[0]
        if pad:
            cells = torch.nn.functional.pad(cells, (0, 0, 0, 0, 0, pad))
            cell_ids = torch.nn.functional.pad(cell_ids, (0, 0, 0, pad), value=-1)
        self._install_cells(cells.to(self.device), cell_ids.to(self.device), mesh)

    def reconstruct_rows(self) -> np.ndarray:
        """→ (n_docs, D) float32 host matrix of the stored (normalized)
        rows in id order — the cells hold the whole corpus, scattered."""
        cells = gathered(self.cells).float().cpu().numpy()
        cells = cells.reshape(-1, cells.shape[-1])
        flat_ids = gathered(self.cell_ids).cpu().numpy().reshape(-1)
        out = np.empty((self.n_docs, cells.shape[1]), np.float32)
        valid = flat_ids >= 0
        out[flat_ids[valid]] = cells[valid]
        return out

    def compact(self) -> None:
        """Re-pack the index's device memory after a build that churned it:
        the two large tensors go through host memory, their device blocks
        are released (with the allocator's cached blocks) and they are put
        back into the freed space. Results are unchanged: only buffer
        placement moves."""
        C = int(self.fill.shape[0])
        host = (gathered(self.cells)[:C].cpu(), gathered(self.cell_ids)[:C].cpu())
        self.cells = self.cell_ids = self._shard_fill = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self._install_padded(*host, self.mesh)

    def tune_n_probe(self, queries, k: int = 10,
                     target_recall: float = 0.95,
                     candidates: Optional[List[int]] = None,
                     backend: str = "auto",
                     set_default: bool = True) -> Tuple[int, dict]:
        """Pick the smallest ``n_probe`` meeting a recall target.

        Ground truth is this index's own exhaustive search
        (``n_probe = n_cells`` scans every cell, which is exact — the
        cells hold the whole corpus, see :meth:`reconstruct_rows`), so no
        separate exact index or original corpus is needed. Candidates
        default to powers of two up to the cell count; they are probed in
        ascending order and the sweep stops at the first one whose
        recall@k on the given query sample reaches ``target_recall``
        (falling back to the exact full probe when none does).
        ``set_default=True`` installs the winner as ``default_n_probe``
        (the value the Retriever/serving path uses).

        → ``(n_probe, {candidate: recall})`` — the measured curve is
        returned so callers can log the recall/cost trade-off they chose.
        """
        if not 0.0 < target_recall <= 1.0:
            raise ValueError(
                f"target_recall must be in (0, 1], got {target_recall}")
        n_cells = int(self.centroids.shape[0])
        if candidates is None:
            candidates = []
            p = 1
            while p < n_cells:
                candidates.append(p)
                p *= 2
        else:
            given = list(candidates)
            candidates = sorted({int(p) for p in given
                                 if 1 <= int(p) < n_cells})
            if not candidates:
                # a silently-empty sweep would install the exhaustive full
                # probe — the O(N·D) scan IVF exists to avoid
                raise ValueError(
                    f"no candidates in [1, {n_cells}) after filtering "
                    f"{given!r}; pass n_probe values below the cell count")
        k = min(k, self.n_docs)
        q = self._queries(queries)
        if q.ndim != 2 or q.shape[0] == 0:
            raise ValueError(
                f"queries must be a non-empty (Q, D) sample, got {tuple(q.shape)}")
        _, truth = self.search(q, k=k, n_probe=n_cells, backend=backend)
        truth_sets = [set(i for i in row if i is not None) for row in truth]

        curve: dict = {}
        best = n_cells
        for p in candidates:
            _, got = self.search(q, k=k, n_probe=p, backend=backend)
            recall = float(np.mean([
                len(t & {i for i in row if i is not None}) / max(len(t), 1)
                for t, row in zip(truth_sets, got)]))
            curve[p] = recall
            if recall >= target_recall:
                best = p
                break
        if best == n_cells:   # nothing met the target: exact full probe
            curve[n_cells] = 1.0
            warnings.warn(
                f"tune_n_probe: no candidate in {candidates} reached "
                f"recall@{k} >= {target_recall}; "
                + ("installing" if set_default else "returning")
                + f" the exhaustive full probe (n_probe={n_cells}), which "
                "scans every cell — widen the candidate list or lower "
                "target_recall", stacklevel=2)
        if set_default:
            self.default_n_probe = best
        return best, curve

    def search_ids(self, queries, k: int = 10, score: str = "cos_sim",
                   n_probe: Optional[int] = None):
        """→ (scores, external-id lists). Cells store normalized rows, so
        cos ≡ dot; euclid is rejected."""
        if score not in ("cos_sim", "dot_score"):
            raise ValueError("IVF index supports cos_sim/dot_score only "
                             "(cells store normalized rows)")
        return self.search(queries, k=k,
                           n_probe=n_probe or self.default_n_probe)

    def _queries(self, queries) -> torch.Tensor:
        return torch.as_tensor(queries, device=self.device).float()

    def _device_search_retriever(self, q, k: int, score: str = "cos_sim",
                                 tile: int = 0, backend: str = "auto"):
        """The Retriever streaming contract (same positional shape as
        ``ExactIndex._device_search``): one dispatched search at the
        index's default_n_probe, device tensors returned."""
        if score not in ("cos_sim", "dot_score"):
            raise ValueError("IVF index supports cos_sim/dot_score only "
                             "(cells store normalized rows)")
        return self._device_search(self._queries(q), min(k, self.n_docs),
                                   min(self.default_n_probe, self.centroids.shape[0]),
                                   backend)

    def _pallas_eligible(self) -> bool:
        return self.cell_budget % 128 == 0 and self.device.type != "cpu"

    def _sharded_search(self, q: torch.Tensor, k: int, n_probe: int, use_pallas: bool):
        """The shard loop: the probe list once from the replicated centroids,
        then each shard over the probed cells it owns, merged in shard
        order."""
        qf, probe = _probe(q, self.centroids, n_probe)
        cps, L = self.cells_per_shard, self.cell_budget
        qs, ps = replicate(qf, self.mesh), replicate(probe, self.mesh)
        cells, ids = self.cells.blocks, self.cell_ids.blocks

        def shard(i: int, dev):
            def local(col):          # → (local cell ids clamped into the shard, owned)
                pid = col - i * cps
                return pid.clamp(0, cps - 1), (pid >= 0) & (pid < cps)

            if use_pallas:           # a probe the shard does not own → the sentinel cps
                pid, owned = local(ps[dev])
                return _scores_to_docs(qs[dev], torch.where(owned, pid, cps), cells[i],
                                       ids[i], self._shard_fill[i], k)

            def fetch(col):          # the source's masked clamp-gather
                pid, owned = local(col)
                return cells[i][pid], torch.where(owned[:, None], ids[i][pid].long(), -1)

            return _probe_scan(qs[dev].to(cells[i].dtype), ps[dev], fetch, k, L, n_probe)

        return merge_topk(shard_loop(self.mesh, shard), min(k, n_probe * L), self.device)

    def _use_pallas(self, backend: str) -> bool:
        if backend not in ("auto", "pallas", "xla"):
            raise ValueError(f"unknown backend {backend!r}")
        return backend == "pallas" or (backend == "auto" and self._pallas_eligible())

    def _device_search(self, q: torch.Tensor, k: int, n_probe: int,
                       backend: str = "auto"):
        """Dispatch one search; returns device tensors (not synchronized):
        scores (Q, k') f32 and doc positions (Q, k') int64, −1 past the
        probed cells' documents."""
        if self.mesh is not None:
            return self._sharded_search(q, k, n_probe, self._use_pallas(backend))
        if self._use_pallas(backend):
            return _ivf_pallas_search(q, self.centroids, self.cells, self.cell_ids,
                                      self.fill, n_probe, k)
        return _ivf_search(q, self.centroids, self.cells, self.cell_ids, n_probe, k)

    GATHER_BUDGET_BYTES = 1 << 30  # bounds the scan's (Q, L, D) probe gather
    SCORES_BUDGET_BYTES = 1 << 29  # bounds the K6 path's (Q, P·L) f32 scores (and its ids)

    def _q_chunk(self, backend: str, n_probe: int) -> int:
        """Queries per dispatch. The scan materializes a (Q, L, D) probe
        gather → bound by GATHER_BUDGET; the K6 path only the (Q, P·L) f32
        scores and as many int32 doc ids → a far larger chunk."""
        if self._use_pallas(backend):
            row = n_probe * self.cell_budget * 4
            return max(8, min(8192, self.SCORES_BUDGET_BYTES // row))
        cells = self.cells if self.mesh is None else self.cells.blocks[0]
        row = self.cell_budget * cells.shape[-1] * cells.element_size()
        return max(8, min(1024, self.GATHER_BUDGET_BYTES // row))

    def _host_pair(self, s: torch.Tensor, i: torch.Tensor):
        i = i.cpu().numpy()
        return s.cpu().numpy(), [[self.ids[j] if j >= 0 else None for j in row] for row in i]

    def search(self, queries, k: int = 10, n_probe: int = 8,
               backend: str = "auto") -> Tuple[np.ndarray, List[list]]:
        """→ (scores (Q, k'), per-query id lists; ``None`` where the probed
        cells held fewer than k' documents). backend: "auto" takes K6 on a
        GPU index whose cell budget is a multiple of 128, else the probe
        scan; "pallas" / "xla" force one (on a CPU index "pallas" runs K6's
        plain version)."""
        n_probe = min(n_probe, self.centroids.shape[0])
        q = self._queries(queries)
        chunk = self._q_chunk(backend, n_probe)
        outs = [self._device_search(q[lo:lo + chunk], k, n_probe, backend)
                for lo in range(0, q.shape[0], chunk)]
        return self._host_pair(torch.cat([o[0] for o in outs]),
                               torch.cat([o[1] for o in outs]))

    def search_stream(self, query_batches, k: int = 10, n_probe: int = 8,
                      depth: int = 4, backend: str = "auto"):
        """Pipelined serving loop over batches of queries: yields one
        ``(scores, ids)`` pair per batch in input order, keeping up to
        ``depth`` searches queued on the device before copying the oldest
        result back."""
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        n_probe = min(n_probe, self.centroids.shape[0])
        pending: List = []
        for q in query_batches:
            pending.append(self._device_search(self._queries(q), k, n_probe, backend))
            if len(pending) >= depth:
                yield self._host_pair(*pending.pop(0))
        while pending:
            yield self._host_pair(*pending.pop(0))
