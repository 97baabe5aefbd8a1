"""4-bit ("fast-scan") product quantization — counterpart of
``qst_tpu/retrieval/pq4.py``.

Two codes share a byte (the even subspace in the low nibble), so at m bytes
per doc a corpus has 2m subspaces of 16 centroids each over D/(2m)
dimensions — the same memory as 8-bit PQ with m subspaces, at a coarser
quantization point that residual encoding and the exact refine recover
(``IVFPQIndex(bits=4)``).

The JAX package decodes through one block-diagonal one-hot product a pack of
``GROUP`` subspaces (``decode4_rows``), because a TPU's matrix unit wants
K = 512 contractions and dislikes gathers. A one-hot row picks exactly one
codebook entry, so the gather ``cb[subspace, code]`` gives the same bits:
``decode4_gather`` is what the port's searches run, ``decode4_rows`` stays
for the equivalence (``tests/test_torch_pq.py``) and for ``pq4_reconstruct``.

Training draws its initial centroids from a ``torch.Generator``
(``jax.random.choice`` has no torch twin); ``pq_lloyd`` takes given initial
codebooks, which is how a test carries JAX's draw across.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from qst_tpu_torch.retrieval.pq import _aniso_fit, _compute_dtype, gather_codewords, pq_lloyd

K4 = 16          # centroids per 4-bit subspace
GROUP = 32       # subspaces folded per block-diagonal decode product


def n_groups(n_sub: int) -> int:
    """Number of decode packs for ``n_sub`` subspaces (callers keep
    n_sub % GROUP == 0 or n_sub < GROUP)."""
    g = min(GROUP, n_sub)
    if n_sub % g:
        raise ValueError(f"n_sub={n_sub} not a multiple of group={g}")
    return n_sub // g


def pq4_train(sample: torch.Tensor, generator: torch.Generator, m: int,
              n_iters: int = 16, init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-subspace 16-way Lloyd k-means in raw space (callers pass
    residuals or unit rows; no re-normalization). → (m, 16, ds) f32. The
    initial centroids are 16 distinct sample rows drawn with ``generator``
    (a CPU generator) unless ``init`` gives them."""
    s, d = sample.shape
    xs = sample.float().reshape(s, m, d // m).transpose(0, 1)     # (m, S, ds)
    if init is None:
        idx = torch.randperm(s, generator=generator)[:K4].to(xs.device)
        init = xs[:, idx, :]
    return pq_lloyd(xs, init, n_iters)


def pq4_encode(vectors: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Encode raw vectors against (m, 16, ds) codebooks and pack two codes a
    byte → (B, m // 2) uint8, the even subspace in the low nibble."""
    m, _, ds = codebooks.shape
    if m % 2:
        raise ValueError(f"4-bit packing needs an even subspace count, got {m}")
    x = vectors.float()
    xs = x.reshape(x.shape[0], m, ds).transpose(0, 1)
    codes = torch.argmax(_aniso_fit(xs, codebooks.float(), 0.0), dim=-1).T   # (B, m)
    return (codes[:, 0::2] | (codes[:, 1::2] << 4)).to(torch.uint8)


def unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """(…, m/2) uint8 → (…, m) int64 codes in subspace order."""
    p = packed.long()
    return torch.stack([p & 0xF, p >> 4], dim=-1).reshape(*packed.shape[:-1], -1)


def block_codebooks(codebooks: torch.Tensor) -> torch.Tensor:
    """(m, 16, ds) → (packs, g·16, g·ds) block-diagonal decode matrices
    (pack p, block j holds subspace p·g+j's codebook at row block j·16,
    column block j·ds; zeros elsewhere)."""
    m, k, ds = codebooks.shape
    p = n_groups(m)
    g = m // p
    cb = codebooks.reshape(p, g, k, ds)
    eye = torch.eye(g, dtype=cb.dtype, device=cb.device)
    blk = torch.einsum("pjkd,ji->pjkid", cb, eye)
    return blk.reshape(p, g * k, g * ds)


def decode4_rows(packed: torch.Tensor, cb_block: torch.Tensor) -> torch.Tensor:
    """(T, m/2) uint8 → (T, D) through the block-diagonal one-hot product
    (the JAX package's decode). ``cb_block`` from :func:`block_codebooks`,
    already in the compute dtype."""
    p, gk, gd = cb_block.shape
    g = gk // K4
    T = packed.shape[0]
    codes = unpack_nibbles(packed).reshape(T, p, g)
    oh = torch.nn.functional.one_hot(codes, K4).to(torch.float32).reshape(T, p, gk)
    rec = torch.einsum("tpk,pkd->tpd", oh, cb_block.float())
    return rec.reshape(T, p * gd).to(cb_block.dtype)


def decode4_gather(packed: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """(T, m/2) uint8 → (T, D) by a gather from the (m, 16, ds) codebooks:
    the same bits as :func:`decode4_rows`, in the codebooks' dtype."""
    m, k, ds = codebooks.shape
    codes = unpack_nibbles(packed)                                  # (T, m)
    flat = codes + torch.arange(m, device=codes.device) * k
    return gather_codewords(codebooks, flat).reshape(packed.shape[0], m * ds)


def pq4_reconstruct(packed: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """f32 reconstruction (tests, goldens): packed (B, m/2) → (B, D)."""
    return decode4_rows(packed, block_codebooks(codebooks.float())).float()


def compute_block_codebooks(codebooks: torch.Tensor) -> torch.Tensor:
    """Blocked codebooks in the compute dtype of their device."""
    return block_codebooks(codebooks).to(_compute_dtype(codebooks.device))


def pq4_mse(sample: torch.Tensor, codebooks: torch.Tensor) -> float:
    """Mean squared reconstruction error of ``sample`` (build-time probe)."""
    rec = pq4_reconstruct(pq4_encode(sample, codebooks), codebooks)
    return float(torch.mean((rec - sample.float()) ** 2))


def validate_pq4_dims(d: int, n_sub: int) -> Tuple[int, int]:
    """Check (D, subspace count) compatibility → (ds, packs)."""
    if n_sub % 2:
        raise ValueError(f"4-bit subspace count must be even, got {n_sub}")
    if d % n_sub:
        raise ValueError(f"dim {d} not divisible by {n_sub} subspaces")
    return d // n_sub, n_groups(n_sub)
