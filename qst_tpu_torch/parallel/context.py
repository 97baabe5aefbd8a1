"""Context parallelism: sequence-sharded attention over a mesh — counterpart
of ``qst_tpu/parallel/context.py``.

Two schemes over the shards of one mesh axis (``core/meshes.py``), every
shard's products on its own device; each process runs the shards it owns
and every process gets the whole output:

- ``context_parallel_attention``: K/V split on the sequence, Q replicated.
  Each shard takes partial attention against its K/V block with softmax
  statistics (running max m, sum l); every shard's (o, m, l) is gathered in
  shard order (``core/meshes.py:gather_rows``) and combined alike on every
  process — the JAX package's ``pmax`` + two ``psum`` s: m_g = max m_i,
  l = Σ e^(m_i − m_g) l_i, o = Σ e^(m_i − m_g) o_i — on the queries'
  device. The gradients come back through ``row_scatter``: Q's summed over
  the shards in shard order, K's and V's blocks concatenated.
- ``ring_attention``: Q and K/V split on the sequence. The K/V blocks rotate
  n − 1 times, shard i handing its block to shard i + 1 (``.to`` within a
  process, a hand-off between processes: ``core/meshes.py:exchange``, the
  JAX package's ``ppermute``), each shard folding the block in front of it
  into its online-softmax state; the output blocks are gathered in
  sequence order. Its backward is one autograd node that runs the ring in
  reverse: each shard recomputes its state over the blocks it held and
  differentiates it, then the K/V gradients travel back around the ring,
  each shard adding its own to what the next handed it; no autograd call
  waits for another process.

The JAX package writes both as plain einsums outside any Pallas kernel, and
so does this module (``torch.einsum``). Both equal ``full_attention`` up to
f32 rounding, and a mesh across processes gives the bits of the
one-process mesh of the same shape.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from qst_tpu_torch.core.meshes import (
    DATA_AXIS,
    Mesh,
    as_mesh,
    exchange,
    gather_columns,
    gather_rows,
    row_scatter,
)


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


def _shards(x: torch.Tensor, mesh: Mesh, axis: str) -> Tuple[List[int], List[torch.device]]:
    """→ (each shard's owning process, each shard's device) of ``axis``; the
    sequence (dim 2) must split into one block a shard, and this process
    must own one."""
    devs, owners = mesh.axis_devices(axis), mesh.axis_ranks(axis)
    if x.shape[2] % len(devs):
        raise ValueError(f"sequence length {x.shape[2]} does not split into "
                         f"{len(devs)} shards of the {axis!r} axis")
    if mesh.rank not in owners:
        raise ValueError(f"process {mesh.rank} owns no shard of the {axis!r} axis "
                         f"(owners {owners})")
    return owners, devs


def context_parallel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               mesh: Mesh, axis: str = DATA_AXIS) -> torch.Tensor:
    """K/V sharded on ``axis`` (sequence dim), Q replicated → full attention
    (f32) on the queries' device: partial attention per shard, then the
    online-softmax combine across shards."""
    mesh = as_mesh(mesh)
    owners, devs = _shards(k, mesh, axis)
    own = [devs[i] for i, r in enumerate(owners) if r == mesh.rank]
    scale = q.shape[-1] ** -0.5
    home, D = q.device, q.shape[-1]
    parts = [_partial_attention(qb, kb, vb, scale) for qb, kb, vb in zip(
        row_scatter(q, owners, own), row_scatter(k, owners, own, dim=2),
        row_scatter(v, owners, own, dim=2))]
    # this process's shards' (o, m, l), then every process's in rank order,
    # which is shard order
    every = gather_rows(torch.stack([torch.cat([o, m[..., None], l[..., None]], -1).to(home)
                                     for o, m, l in parts])).unbind(0)
    o_l, m_l, l_l = ([e[..., :D] for e in every], [e[..., D] for e in every],
                     [e[..., D + 1] for e in every])
    m_g = torch.stack(m_l).amax(dim=0)                       # pmax
    alpha = [torch.exp(m - m_g) for m in m_l]
    l_g = sum(a * l for a, l in zip(alpha, l_l))             # psum
    o_g = sum(a[..., None] * o for a, o in zip(alpha, o_l))  # psum
    return o_g / l_g[..., None]


def _fold(state, qb: torch.Tensor, kb: torch.Tensor, vb: torch.Tensor, scale: float):
    """One ring step of a shard: the K/V block in front of it folded into its
    online-softmax state (m, l, o)."""
    m, l, o = state
    s = torch.einsum("bhqd,bhkd->bhqk", qb.float(), kb.float()) * scale
    m_n = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_n)
    p = torch.exp(s - m_n[..., None])
    return (m_n, alpha * l + p.sum(dim=-1),
            alpha[..., None] * o + torch.einsum("bhqk,bhkd->bhqd", p, vb.float()))


def _ring_out(qb: torch.Tensor, blocks) -> torch.Tensor:
    """A shard's output block: its queries against ``blocks`` ((K, V) in
    the order it held them), in q's dtype."""
    B, H, Sq, D = qb.shape
    state = (torch.full((B, H, Sq), float("-inf"), device=qb.device),
             torch.zeros((B, H, Sq), device=qb.device),
             torch.zeros((B, H, Sq, D), device=qb.device))
    for kb, vb in blocks:
        state = _fold(state, qb, kb, vb, D ** -0.5)
    _, l, o = state
    return (o / l[..., None]).to(qb.dtype)


class _Ring(torch.autograd.Function):
    """``apply(rank, owners, devices, q, k, v)`` → the ring's output, every
    block, on every process."""

    @staticmethod
    def forward(ctx, rank, owners, devs, q, k, v):
        n = len(owners)
        mine = [i for i, r in enumerate(owners) if r == rank]
        qs = {i: q.chunk(n, dim=2)[i].to(devs[i]) for i in mine}
        ks, vs = k.chunk(n, dim=2), v.chunk(n, dim=2)
        held = {i: torch.stack([ks[i], vs[i]]).to(devs[i]) for i in mine}
        seen = {i: [] for i in mine}
        for step in range(n):
            for i in mine:
                seen[i].append(held[i])
            if step < n - 1:   # shard i hands its block to shard i + 1
                held = _rotate(held, owners, devs, rank, +1)
        outs = {i: _ring_out(qs[i], [(kv[0], kv[1]) for kv in seen[i]]) for i in mine}
        ctx.rank, ctx.owners, ctx.devs, ctx.mine = rank, owners, devs, mine
        ctx.seen, ctx.qs = seen, qs
        ctx.homes = (q.device, k.device, v.device)
        full = gather_columns({i: outs[i] for i in mine}, owners)
        return torch.cat([o.to(q.device) for o in full], dim=2)

    @staticmethod
    def backward(ctx, grad):
        owners, devs, mine, n = ctx.owners, ctx.devs, ctx.mine, len(ctx.owners)
        g_blocks = grad.chunk(n, dim=2)
        dq, dkv = {}, {}
        for i in mine:
            with torch.enable_grad():
                qb = ctx.qs[i].detach().requires_grad_()
                kvs = [kv.detach().requires_grad_() for kv in ctx.seen[i]]
                out = _ring_out(qb, [(kv[0], kv[1]) for kv in kvs])
                torch.autograd.backward(out, g_blocks[i].to(out.device))
            dq[i] = qb.grad
            dkv[i] = [kv.grad for kv in kvs]
        # the K/V gradients back around the ring: at step s shard i held the
        # block shard i - 1 held at step s - 1, so it hands its sum back there
        acc = {i: dkv[i][n - 1] for i in mine}
        for step in range(n - 1, 0, -1):
            back = _rotate(acc, owners, devs, ctx.rank, -1)
            acc = {i: dkv[i][step - 1] + back[i] for i in mine}
        full = gather_columns({i: torch.cat([dq[i][None], acc[i]]) for i in mine}, owners)
        dq_, dk_, dv_ = (torch.cat([f[c].to(h) for f in full], dim=2)
                         for c, h in zip(range(3), ctx.homes))
        ctx.seen = ctx.qs = None
        return None, None, None, dq_, dk_, dv_


def _rotate(blocks: dict, owners: List[int], devs: List[torch.device], rank: int,
            shift: int) -> dict:
    """Each shard i's tensor (``blocks``: this process's shards') to shard
    i + shift (mod n), on its device: a ``.to`` within this process, a
    hand-off between processes, all the ring's transfers posted before any
    is waited for."""
    n = len(owners)
    like = next(iter(blocks.values()))
    moves = [(i, (i + shift) % n) for i in range(n)]
    moves = [(i, j) for i, j in moves if rank in (owners[i], owners[j])]
    got = exchange([(blocks[i] if owners[i] == rank else like.new_empty(like.shape).to(devs[j]),
                     owners[i], owners[j]) for i, j in moves])
    return {j: t.to(devs[j]) for (i, j), t in zip(moves, got) if owners[j] == rank}


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh,
                   axis: str = DATA_AXIS) -> torch.Tensor:
    """Q and K/V sharded on ``axis``: the K/V blocks rotate around the shards
    while each folds them into its online-softmax state. → the output in
    q's dtype on the queries' device, the shards' blocks concatenated in
    sequence order."""
    mesh = as_mesh(mesh)
    owners, devs = _shards(q, mesh, axis)
    return _Ring.apply(mesh.rank, owners, devs, q, k, v)
