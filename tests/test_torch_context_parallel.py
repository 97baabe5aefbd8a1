"""``qst_tpu_torch/parallel/context.py`` against ``qst_tpu/parallel/context.py``:
the four cases of ``tests/test_context_parallel.py`` on the same numpy
inputs — full attention, context-parallel and ring attention over 8 shards
(the JAX side on the 8-device mesh, the port on a mesh of eight CPU
positions) within 1e-5, the ring's output split like Q, and gradients —
plus the port's gradients against full attention's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qst_tpu.core.meshes import make_mesh as jax_make_mesh
from qst_tpu.parallel import context_parallel_attention as jax_cp
from qst_tpu.parallel import full_attention as jax_full
from qst_tpu.parallel import ring_attention as jax_ring
from qst_tpu_torch.core.meshes import make_mesh
from qst_tpu_torch.parallel import context_parallel_attention, full_attention, ring_attention

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def meshes():
    return (jax_make_mesh(data=8, model=1, devices=jax.devices()),
            make_mesh(8, 1, devices=["cpu"] * 8))


@pytest.fixture
def qkv(rng):
    B, H, S, D = 2, 4, 64, 16  # S divisible by 8 shards
    return [rng.standard_normal((B, H, S, D)).astype(np.float32) for _ in range(3)]


def test_full_attention_matches_jax(qkv):
    want = np.asarray(jax_full(*map(jnp.asarray, qkv)))
    np.testing.assert_allclose(full_attention(*map(torch.from_numpy, qkv)).numpy(), want, **TOL)


@pytest.mark.parametrize("scheme", ["context", "ring"])
def test_sharded_attention_matches_jax_and_full(meshes, qkv, scheme):
    jmesh, tmesh = meshes
    jfn, tfn = {"context": (jax_cp, context_parallel_attention),
                "ring": (jax_ring, ring_attention)}[scheme]
    want = np.asarray(jfn(*map(jnp.asarray, qkv), jmesh, axis="data"))
    got = tfn(*map(torch.from_numpy, qkv), tmesh, axis="data")
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(),
                               full_attention(*map(torch.from_numpy, qkv)).numpy(), **TOL)


def test_ring_attention_output_stays_sharded(meshes, qkv):
    _, tmesh = meshes
    q, k, v = map(torch.from_numpy, qkv)
    out = ring_attention(q, k, v, tmesh, axis="data")
    assert out.shape == q.shape and out.dtype == q.dtype and out.device == q.device
    blocks, want = out.chunk(8, dim=2), full_attention(q, k, v).chunk(8, dim=2)
    assert all(b.shape == (2, 4, 8, 16) for b in blocks)
    for b, w in zip(blocks, want):    # shard i's query rows, seq-split like Q
        np.testing.assert_allclose(b.numpy(), w.numpy(), **TOL)


def test_context_parallel_grad(meshes, qkv):
    """Both schemes differentiate by autograd; the ring's gradient in q
    equals JAX's, and both schemes' gradients in q, k and v equal full
    attention's."""
    jmesh, tmesh = meshes
    jq, jk, jv = map(jnp.asarray, qkv)
    want = np.asarray(jax.grad(lambda x: jax_ring(x, jk, jv, jmesh, "data").sum())(jq))
    assert np.isfinite(want).all()
    ref = [torch.from_numpy(x).requires_grad_() for x in qkv]
    full_attention(*ref).sum().backward()
    for fn in (ring_attention, context_parallel_attention):
        xs = [torch.from_numpy(x).requires_grad_() for x in qkv]
        fn(*xs, tmesh, "data").sum().backward()
        if fn is ring_attention:
            np.testing.assert_allclose(xs[0].grad.numpy(), want, rtol=1e-4, atol=1e-5)
        for x, r in zip(xs, ref):
            np.testing.assert_allclose(x.grad.numpy(), r.grad.numpy(), rtol=1e-4, atol=1e-5)


def test_sequence_must_split(meshes, rng):
    _, tmesh = meshes
    x = torch.from_numpy(rng.standard_normal((1, 2, 60, 8)).astype(np.float32))
    with pytest.raises(ValueError, match="does not split"):
        ring_attention(x, x, x, tmesh)
