"""K6: the IVF probed-cell scorer — counterpart of
``qst_tpu/ops/ivf_pallas.py``.

``ivf_cell_scores(queries, cells, probe)`` gives every query's dot products
with every slot of its P probed cells, fetched from the (C, L, D) cell
tensor by probe id::

    out[q, p·L + l] = Σ_d queries[q, d] · cells[probe[q, p], l, d]

Queries are cast to the cell dtype first (as ``ivf_pallas.py:80``), products
accumulate in f32, and every slot is scored, the zero rows of padded slots
included: the caller (``retrieval/ivf.py``) masks slots at or past each
cell's fill count and resolves doc ids.

The kernel is CUDA C++ in ``kernels/csrc/ivf.cu`` (its header says what
bounds it on the H100 — the gather's bytes — and what the design does about
it). The wrapper takes the plain version only for CPU tensors; CUDA tensors
launch the kernel or raise. ``ivf_cell_scores.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_PLAIN_GATHER_BYTES = 1 << 28   # f32 bytes of gathered cells per chunk of the plain version


def _check(queries: torch.Tensor, cells: torch.Tensor, probe: torch.Tensor) -> None:
    if (queries.ndim != 2 or cells.ndim != 3 or probe.ndim != 2
            or queries.shape[1] != cells.shape[2] or probe.shape[0] != queries.shape[0]):
        raise ValueError(
            f"queries (Q, D), cells (C, L, D) and probe (Q, P) expected, got "
            f"{tuple(queries.shape)}, {tuple(cells.shape)}, {tuple(probe.shape)}")
    if probe.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"probe must hold int32/int64 cell ids, got {probe.dtype}")


def ivf_cell_scores_plain(queries: torch.Tensor, cells: torch.Tensor,
                          probe: torch.Tensor) -> torch.Tensor:
    """Plain version of K6: (Q, P·L) f32. Gather, upcast to f32 (exact
    products, f32 sums) and contract, chunked over queries so the
    (Q, P, L, D) f32 gather is never whole."""
    _check(queries, cells, probe)
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
    return out


_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def ivf_cell_scores(queries: torch.Tensor, cells: torch.Tensor,
                    probe: torch.Tensor) -> torch.Tensor:
    """→ (Q, P·L) f32 raw scores of each query against its P probed cells.

    ``cells`` (C, L, D) f32 or bf16, contiguous; ``probe`` (Q, P) cell ids.
    On the card D·itemsize must be a multiple of 16 (16-byte loads), and a
    probe id outside [0, C) scores −inf without reading (the plain version
    raises): the ids are not copied to the host to be checked."""
    _check(queries, cells, probe)
    if all(t.device.type == "cpu" for t in (queries, cells, probe)):
        return ivf_cell_scores_plain(queries, cells, probe)
    if cells.device.type != "cuda" or not (queries.device == probe.device == cells.device):
        raise ValueError(
            f"ivf_cell_scores: queries, cells and probe must be on one CUDA device, got "
            f"{queries.device}, {cells.device}, {probe.device}")
    if cells.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"ivf_cell_scores: kernel takes float32/bfloat16 cells, got {cells.dtype}")
    Q, P = probe.shape
    C, L, D = cells.shape
    row_bytes = D * cells.element_size()
    if row_bytes % 16 or row_bytes > 48 * 1024:
        raise ValueError(
            f"ivf_cell_scores kernel needs D % 8 == 0 (bf16) / % 4 (f32) and D·itemsize "
            f"<= 48 KiB, got D={D}")
    if Q * P * -(-L // 64) >= 1 << 31:
        raise ValueError(f"ivf_cell_scores: Q·P·ceil(L/64) = {Q * P * -(-L // 64)} blocks "
                         "exceed one grid; chunk the queries")
    q = queries.to(cells.dtype).contiguous()
    ids = probe.to(torch.int32).contiguous()
    if not cells.is_contiguous() or cells.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("ivf_cell_scores: operands must be contiguous and 16-byte aligned")
    out = torch.empty((Q, P * L), dtype=torch.float32, device=cells.device)
    if Q == 0 or P == 0:
        return out
    from qst_tpu_torch.kernels import build

    fn = build.function("qst_ivf_cell_scores", _ARGTYPES)
    with torch.cuda.device(cells.device):   # launch into the tensors' device context
        code = fn(build.DTYPE_CODES[str(cells.dtype).removeprefix("torch.")], q.data_ptr(),
                  cells.data_ptr(), ids.data_ptr(), out.data_ptr(), Q, C, L, D, P,
                  torch.cuda.current_stream(cells.device).cuda_stream)
    ivf_cell_scores.launches += 1
    build.check(code, "ivf_cell_scores")
    return out


ivf_cell_scores.launches = 0
