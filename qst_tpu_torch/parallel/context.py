"""Context parallelism: sequence-sharded attention over a mesh — counterpart
of ``qst_tpu/parallel/context.py``.

Two schemes, each one loop over the shards of a mesh axis
(``core/meshes.py``), every shard's products on its own device:

- ``context_parallel_attention``: K/V split on the sequence, Q replicated.
  Each shard takes partial attention against its K/V block with softmax
  statistics (running max m, sum l); the combine is the JAX package's
  ``pmax`` + two ``psum`` s — m_g = max m_i, l = Σ e^(m_i − m_g) l_i,
  o = Σ e^(m_i − m_g) o_i — on the queries' device.
- ``ring_attention``: Q and K/V split on the sequence. The K/V blocks rotate
  n − 1 times, shard i handing its block to shard i + 1 (``ppermute`` as a
  ``.to`` of the next shard's device), each shard folding the block in
  front of it into its online-softmax state; shard i keeps the
  output rows of its Q block, concatenated in sequence order at the end.

The JAX package writes both as plain einsums outside any Pallas kernel, and
so does this module (``torch.einsum``); gradients flow through both by
autograd. Both equal ``full_attention`` up to f32 rounding.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from qst_tpu_torch.core.meshes import DATA_AXIS, Mesh, as_mesh


def _partial_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q (B, H, Sq, D), k / v (B, H, Skv, D) → (o_unnorm (B, H, Sq, D),
    m (B, H, Sq), l (B, H, Sq)): ``o_unnorm = Σ exp(s − m) v`` and
    ``l = Σ exp(s − m)``, f32."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()), m, p.sum(dim=-1)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Unsharded reference: softmax(QKᵀ/√d) V, f32."""
    o, _, l = _partial_attention(q, k, v, q.shape[-1] ** -0.5)
    return o / l[..., None]


def _blocks(x: torch.Tensor, mesh: Mesh, axis: str) -> List[torch.Tensor]:
    """x split on the sequence (dim 2) into one block per shard of ``axis``,
    block i on that shard's device."""
    devs = mesh.axis_devices(axis)
    if x.shape[2] % len(devs):
        raise ValueError(f"sequence length {x.shape[2]} does not split into "
                         f"{len(devs)} shards of the {axis!r} axis")
    return [b.to(d) for b, d in zip(x.chunk(len(devs), dim=2), devs)]


def context_parallel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               mesh: Mesh, axis: str = DATA_AXIS) -> torch.Tensor:
    """K/V sharded on ``axis`` (sequence dim), Q replicated → full attention
    (f32) on the queries' device: partial attention per shard, then the
    online-softmax combine across shards."""
    mesh = as_mesh(mesh)
    scale = q.shape[-1] ** -0.5
    parts = [_partial_attention(q.to(kb.device), kb, vb, scale)
             for kb, vb in zip(_blocks(k, mesh, axis), _blocks(v, mesh, axis))]
    home = q.device
    o_l, m_l, l_l = ([t.to(home) for t in ts] for ts in zip(*parts))
    m_g = torch.stack(m_l).amax(dim=0)                       # pmax
    alpha = [torch.exp(m - m_g) for m in m_l]
    l_g = sum(a * l for a, l in zip(alpha, l_l))             # psum
    o_g = sum(a[..., None] * o for a, o in zip(alpha, o_l))  # psum
    return o_g / l_g[..., None]


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh,
                   axis: str = DATA_AXIS) -> torch.Tensor:
    """Q and K/V sharded on ``axis``: the K/V blocks rotate around the shards
    while each folds them into its online-softmax state. → the output in
    q's dtype on the queries' device, the shards' blocks concatenated in
    sequence order."""
    mesh = as_mesh(mesh)
    scale = q.shape[-1] ** -0.5
    qs, ks, vs = (_blocks(x, mesh, axis) for x in (q, k, v))
    n = len(qs)
    state = []
    for qb in qs:
        B, H, Sq, D = qb.shape
        state.append((torch.full((B, H, Sq), float("-inf"), device=qb.device),
                      torch.zeros((B, H, Sq), device=qb.device),
                      torch.zeros((B, H, Sq, D), device=qb.device)))
    for step in range(n):
        for i, (qb, kb, vb) in enumerate(zip(qs, ks, vs)):
            m, l, o = state[i]
            s = torch.einsum("bhqd,bhkd->bhqk", qb.float(), kb.float()) * scale
            m_n = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_n)
            p = torch.exp(s - m_n[..., None])
            state[i] = (m_n, alpha * l + p.sum(dim=-1),
                        alpha[..., None] * o + torch.einsum("bhqk,bhkd->bhqd", p, vb.float()))
        if step < n - 1:   # shard i hands its block to shard i + 1
            ks = [ks[i - 1].to(qs[i].device) for i in range(n)]
            vs = [vs[i - 1].to(qs[i].device) for i in range(n)]
    return torch.cat([(o / l[..., None]).to(q.dtype).to(q.device) for _, l, o in state],
                     dim=2)
