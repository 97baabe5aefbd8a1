"""K3, the fused γ-quadruplet loss: the port's plain forward and backward
against ``fused_gamma_quadruplet_loss(..., interpret=True)`` and its
``jax.grad``, on the same numpy inputs. Tolerance 1e-5 relative / 1e-6
absolute in f32 (another summation order over D). The CUDA kernels run only
on a GPU (``cuda`` marker; skipped here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qst_tpu.ops.quadruplet_pallas import _forward as jax_forward
from qst_tpu.ops.quadruplet_pallas import fused_gamma_quadruplet_loss as jax_fused
from qst_tpu_torch.ops import quadruplet as qd

TOL = dict(rtol=1e-5, atol=1e-6)
CASES = [(0.6, 1.0, 0.5, 0.5), (0.8, 1.0, 0.25, 0.75), (0.0, 0.3, 0.2, 0.1), (1.0, 2.0, 1.0, 1.0)]


def _inputs(seed, B=12, D=48):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((B, D)).astype(np.float32)
    near = a + 0.3 * rng.standard_normal((B, D)).astype(np.float32)
    return [a, near, rng.standard_normal((B, D)).astype(np.float32),
            rng.standard_normal((B, D)).astype(np.float32)]


@pytest.mark.parametrize("consts", CASES)
def test_plain_forward_matches_tpu_kernel_interpret(consts):
    gamma, m_pn, m_pt, m_tn = consts
    xs = _inputs(0)
    want_loss, want_d = jax_forward(*map(jnp.asarray, xs), gamma, m_pn, m_pt, m_tn, False,
                                    interpret=True)
    loss, dists = qd.fused_gamma_quadruplet_loss_plain(
        *map(torch.from_numpy, xs), gamma=gamma, m_pn=m_pn, m_pt=m_pt, m_tn=m_tn)
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss), **TOL)
    np.testing.assert_allclose(dists.numpy(), np.asarray(want_d), **TOL)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("consts", CASES[:2])
def test_loss_and_gradients_match_jax_grad(consts, reduction):
    xs = _inputs(1)
    ws = np.random.default_rng(2).standard_normal(xs[0].shape[0]).astype(np.float32)

    def jax_loss(*args):
        out = jax_fused(*args, *consts, reduction, True)
        return out if reduction != "none" else jnp.sum(out * ws)

    want, want_g = jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, xs))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    out = qd.fused_gamma_quadruplet_loss(*ts, *consts, reduction=reduction)
    got = out if reduction != "none" else torch.sum(out * torch.from_numpy(ws))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    for t, g in zip(ts, want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL)


@pytest.mark.parametrize("consts", CASES)
def test_plain_backward_matches_the_jnp_vjp(consts):
    """The backward kernel's plain version against the custom VJP's jnp
    backward (``_bwd``) with a per-example upstream gradient."""
    from qst_tpu.ops.quadruplet_pallas import _bwd

    gamma, m_pn, m_pt, m_tn = consts
    xs = _inputs(3)
    _, dists = jax_forward(*map(jnp.asarray, xs), gamma, m_pn, m_pt, m_tn, False,
                           interpret=True)
    g = np.random.default_rng(4).standard_normal(xs[0].shape[0]).astype(np.float32)
    want = _bwd(gamma, m_pn, m_pt, m_tn, "none", True,
                (*map(jnp.asarray, xs), dists), jnp.asarray(g))
    got = qd.fused_gamma_quadruplet_loss_bwd_plain(
        *map(torch.from_numpy, xs), torch.from_numpy(np.array(dists)), torch.from_numpy(g),
        gamma=gamma, m_pn=m_pn, m_pt=m_pt, m_tn=m_tn)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_wrappers_take_the_plain_versions_on_cpu():
    xs = [torch.from_numpy(x) for x in _inputs(5)]
    before = (qd.fused_gamma_quadruplet_loss_fwd.launches,
              qd.fused_gamma_quadruplet_loss_bwd.launches)
    kw = dict(gamma=0.6, m_pn=1.0, m_pt=0.5, m_tn=0.5)
    loss, dists = qd.fused_gamma_quadruplet_loss_fwd(*xs, **kw)
    grads = qd.fused_gamma_quadruplet_loss_bwd(*xs, dists, torch.ones(12), **kw)
    assert (qd.fused_gamma_quadruplet_loss_fwd.launches,
            qd.fused_gamma_quadruplet_loss_bwd.launches) == before
    want = qd.fused_gamma_quadruplet_loss_plain(*xs, **kw)
    assert torch.equal(loss, want[0]) and torch.equal(dists, want[1])
    assert len(grads) == 4 and all(g.shape == xs[0].shape for g in grads)
    with pytest.raises(ValueError, match="reduction"):
        qd.fused_gamma_quadruplet_loss(*xs, reduction="max")


def test_gamma_loss_equals_the_unfused_loss():
    """K3's plain version is the γ-quadruplet loss of ops/losses.py at p=2."""
    from qst_tpu_torch.ops.losses import gamma_quadruplet_loss

    xs = [torch.from_numpy(x) for x in _inputs(6)]
    fused = qd.fused_gamma_quadruplet_loss(*xs, 0.6, 1.0, 0.5, 0.5)
    plain = gamma_quadruplet_loss(*xs, gamma=0.6, margin_pos_neg=1.0, margin_pos_part=0.5,
                                  margin_part_neg=0.5)
    np.testing.assert_allclose(fused.item(), plain.item(), **TOL)


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    xs = [torch.from_numpy(x).to(dev) for x in _inputs(7, B=33, D=384)]
    kw = dict(gamma=0.6, m_pn=1.0, m_pt=0.5, m_tn=0.5)
    loss, dists = qd.fused_gamma_quadruplet_loss_fwd(*xs, **kw)
    rloss, rdists = qd.fused_gamma_quadruplet_loss_plain(*xs, **kw)
    assert (loss - rloss).abs().max().item() <= 1e-5
    assert (dists - rdists).abs().max().item() <= 1e-5
    scale = torch.full((33,), 1.0 / 33, device=dev)
    got = qd.fused_gamma_quadruplet_loss_bwd(*xs, rdists, scale, **kw)
    want = qd.fused_gamma_quadruplet_loss_bwd_plain(*xs, rdists, scale, **kw)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-6
