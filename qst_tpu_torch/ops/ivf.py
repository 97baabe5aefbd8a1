"""K6: the IVF probed-cell scorer — counterpart of
``qst_tpu/ops/ivf_pallas.py``.

``ivf_cell_scores(queries, cells, probe, fill=None)`` gives every query's dot
products with every slot of its P probed cells, fetched from the (C, L, D)
cell tensor by probe id::

    out[q, p·L + l] = Σ_d queries[q, d] · cells[probe[q, p], l, d]

Queries are cast to the cell dtype first (as ``ivf_pallas.py:80``) and
products accumulate in f32. Without ``fill`` every slot is scored, the zero
rows of padded slots included, as the TPU kernel does. With the (C,) fill
counts a slot at or past its cell's count scores −inf, which is the masking
the JAX search applies after its kernel (``qst_tpu/retrieval/ivf.py``), and
on the card its row is never read.

The kernel is CUDA C++ in ``kernels/csrc/ivf.cu``; its header says what
bounds it on the H100 (the filled rows of each distinct probed cell, read
once) and gives the design in full. In short: from ``_GROUP_MIN_PAIRS``
(query, probe) pairs on, the wrapper sorts the pairs by cell id
(``_group_pairs_by_cell``: index glue, one ``torch.sort``) and a block brings
a tile of a cell into shared memory once for the run of pairs that probe it;
below that line few cells are shared and the sort's launches cost more than
they save, so every pair gets its own blocks in the order it came. Either way
the tiles pass through a ring of ``cp.async`` stages and bf16 is scored on
``mma.sync``.

The wrapper takes the plain version only for CPU tensors; CUDA tensors
launch the kernel or raise. ``ivf_cell_scores.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_PLAIN_GATHER_BYTES = 1 << 28   # f32 bytes of gathered cells per chunk of the plain version
# K6 groups its pairs by cell from this many (query, probe) pairs on (K5's own
# line, over its 128-row buckets, is ops/topk.py's _GROUP_MIN_PAIRS)
_GROUP_MIN_PAIRS = 1024
_MAX_PAIRS_PER_BLOCK = 16     # splits a popular cell; a cut run is fetched twice
_MAX_ROW_BYTES = 48 * 1024    # one padded row must fit a block's shared memory


def _check(queries: torch.Tensor, cells: torch.Tensor, probe: torch.Tensor,
           fill: Optional[torch.Tensor]) -> None:
    if (queries.ndim != 2 or cells.ndim != 3 or probe.ndim != 2
            or queries.shape[1] != cells.shape[2] or probe.shape[0] != queries.shape[0]):
        raise ValueError(
            f"queries (Q, D), cells (C, L, D) and probe (Q, P) expected, got "
            f"{tuple(queries.shape)}, {tuple(cells.shape)}, {tuple(probe.shape)}")
    if probe.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"probe must hold int32/int64 cell ids, got {probe.dtype}")
    if fill is not None:
        if fill.shape != (cells.shape[0],):
            raise ValueError(f"fill must be (C,) = ({cells.shape[0]},), got {tuple(fill.shape)}")
        if fill.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"fill must hold int32/int64 counts, got {fill.dtype}")


def ivf_cell_scores_plain(queries: torch.Tensor, cells: torch.Tensor, probe: torch.Tensor,
                          fill: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K6: (Q, P·L) f32. Gather, upcast to f32 (exact
    products, f32 sums) and contract, chunked over queries so the
    (Q, P, L, D) f32 gather is never whole; with ``fill`` slot l of a probed
    cell c scores −inf where l >= fill[c]."""
    _check(queries, cells, probe, fill)
    Q, P = probe.shape
    _, L, D = cells.shape
    q = queries.to(cells.dtype).float()
    idx = probe.long()
    out = torch.empty((Q, P * L), dtype=torch.float32, device=queries.device)
    step = max(1, _PLAIN_GATHER_BYTES // (P * L * D * 4))
    for lo in range(0, Q, step):
        cand = cells[idx[lo:lo + step]].float()                  # (q, P, L, D)
        out[lo:lo + step] = torch.einsum("qd,qpld->qpl", q[lo:lo + step],
                                         cand).reshape(-1, P * L)
    if fill is not None:
        live = torch.arange(L, device=out.device)[None, None, :] < fill[idx][:, :, None]
        out = torch.where(live.reshape(Q, P * L), out, float("-inf"))
    return out


def _group_pairs_by_cell(probe: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, P) cell ids → (ids (Q·P,) in ascending order, order (Q·P,) int64):
    position i of the sorted ids belongs to pair ``order[i]`` = q·P + p.
    Every pair appears once, a repeated (query, cell) as often as it came;
    pairs of one cell are neighbours; ids outside [0, C) keep their place in
    the order (below 0 first, C and above last)."""
    return torch.sort(probe.reshape(-1))


_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 3
             + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def ivf_cell_scores(queries: torch.Tensor, cells: torch.Tensor, probe: torch.Tensor,
                    fill: Optional[torch.Tensor] = None) -> torch.Tensor:
    """→ (Q, P·L) f32 scores of each query against its P probed cells.

    ``cells`` (C, L, D) f32 or bf16, contiguous; ``probe`` (Q, P) cell ids;
    ``fill`` (C,) rows in use per cell, or None for raw scores of every slot.
    On the card D·itemsize must be a multiple of 16 (16-byte copies), and a
    probe id outside [0, C) scores −inf without reading (the plain version
    raises): the ids are not copied to the host to be checked."""
    _check(queries, cells, probe, fill)
    operands = (queries, cells, probe) + (() if fill is None else (fill,))
    if all(t.device.type == "cpu" for t in operands):
        return ivf_cell_scores_plain(queries, cells, probe, fill)
    if cells.device.type != "cuda" or any(t.device != cells.device for t in operands):
        raise ValueError(
            f"ivf_cell_scores: queries, cells, probe and fill must be on one CUDA device, got "
            f"{', '.join(str(t.device) for t in operands)}")
    if cells.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"ivf_cell_scores: kernel takes float32/bfloat16 cells, got {cells.dtype}")
    Q, P = probe.shape
    C, L, D = cells.shape
    row_bytes = D * cells.element_size()
    if row_bytes % 16 or row_bytes > _MAX_ROW_BYTES:
        raise ValueError(
            f"ivf_cell_scores kernel needs D % 8 == 0 (bf16) / % 4 (f32) and D·itemsize "
            f"<= {_MAX_ROW_BYTES} bytes, got D={D}")
    n_pairs = Q * P
    if n_pairs >= 1 << 31:
        raise ValueError(f"ivf_cell_scores: Q·P = {n_pairs} pairs exceed one launch; "
                         "chunk the queries")
    q = queries.to(cells.dtype).contiguous()
    ids = probe.contiguous()        # int32 or int64 as it came: the kernel reads either
    counts = None if fill is None else fill.to(torch.int32).contiguous()
    if not cells.is_contiguous() or cells.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("ivf_cell_scores: operands must be contiguous and 16-byte aligned")
    out = torch.empty((Q, P * L), dtype=torch.float32, device=cells.device)
    if Q == 0 or P == 0 or L == 0:
        return out
    if n_pairs >= _GROUP_MIN_PAIRS:
        ids, order = _group_pairs_by_cell(ids)
        order_ptr = order.data_ptr()
        # runs long enough to share a cell, blocks enough to fill the card
        pairs_per_block = max(1, min(_MAX_PAIRS_PER_BLOCK, n_pairs // 128))
    else:
        order_ptr, pairs_per_block = None, 1
    from qst_tpu_torch.kernels import build

    fn = build.function("qst_ivf_cell_scores", _ARGTYPES)
    with torch.cuda.device(cells.device):   # launch into the tensors' device context
        code = fn(build.DTYPE_CODES[str(cells.dtype).removeprefix("torch.")], q.data_ptr(),
                  cells.data_ptr(), ids.data_ptr(), int(ids.dtype == torch.int64), order_ptr,
                  None if counts is None else counts.data_ptr(), out.data_ptr(), Q, C, L, D, P,
                  pairs_per_block, torch.cuda.current_stream(cells.device).cuda_stream)
    build.count_launch(ivf_cell_scores)
    build.check(code, "ivf_cell_scores")
    return out


ivf_cell_scores.launches = 0
