"""The port's losses, pairwise distance and pair discriminator against
``qst_tpu.ops.losses``, ``qst_tpu.ops.distances`` and
``qst_tpu.models.discriminator`` on the same numpy inputs, f32: rtol 1e-6 /
atol 1e-6 for values (same arithmetic, another summation order), 1e-5 for
gradients (autograd in both packages).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qst_tpu.models import discriminator as jdisc
from qst_tpu.ops import distances as jdist
from qst_tpu.ops import losses as jl
from qst_tpu_torch.models import discriminator as tdisc
from qst_tpu_torch.ops import distances as tdist
from qst_tpu_torch.ops import losses as tl

TOL = dict(rtol=1e-6, atol=1e-6)
GTOL = dict(rtol=1e-5, atol=1e-6)


def _quad(seed, B=10, D=24):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((B, D)).astype(np.float32)
    return [a, a + 0.4 * rng.standard_normal((B, D)).astype(np.float32),
            rng.standard_normal((B, D)).astype(np.float32),
            rng.standard_normal((B, D)).astype(np.float32)]


@pytest.mark.parametrize("p", [2.0, 1.0, 3.0, 0.5])
def test_pairwise_distance_matches_jax(p):
    x, y = _quad(0)[:2]
    want = np.asarray(jdist.pairwise_distance(jnp.asarray(x), jnp.asarray(y), p=p))
    got = tdist.pairwise_distance(torch.from_numpy(x), torch.from_numpy(y), p=p).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5 if p == 0.5 else 1e-6, atol=1e-6)


@pytest.mark.parametrize("swap", [False, True])
@pytest.mark.parametrize("p", [2.0, 1.0])
def test_triplet_margin_loss_matches_jax(swap, p):
    a, pos, _, neg = _quad(1)
    want = np.asarray(jl.triplet_margin_loss(*map(jnp.asarray, (a, pos, neg)), 0.7, p, swap))
    got = tl.triplet_margin_loss(*map(torch.from_numpy, (a, pos, neg)), 0.7, p, swap).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("gamma,swap", [(0.6, False), (0.8, True), (0.0, False)])
def test_gamma_quadruplet_loss_and_gradients_match_jax(reduction, gamma, swap):
    xs = _quad(2)
    kw = dict(gamma=gamma, margin_pos_neg=1.0, margin_pos_part=0.25, margin_part_neg=0.75,
              swap=swap, reduction=reduction)

    def jax_total(*args):
        return jnp.sum(jl.gamma_quadruplet_loss(*args, **kw))

    want, want_g = jax.value_and_grad(jax_total, argnums=(0, 1, 2, 3))(*map(jnp.asarray, xs))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    out = tl.gamma_quadruplet_loss(*ts, **kw)
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jl.gamma_quadruplet_loss(*map(jnp.asarray, xs), **kw)),
                               **TOL)
    out.sum().backward()
    np.testing.assert_allclose(out.sum().item(), float(want), **TOL)
    for t, g in zip(ts, want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **GTOL)


def test_reduce3_keeps_the_source_association_order():
    """Each term is reduced on its own and the three sums added left to
    right: bit-equal to the JAX formula on the same f32 terms."""
    rng = np.random.default_rng(3)
    a, b, c = (rng.random(1000).astype(np.float32) * 10 for _ in range(3))
    for reduction in ("mean", "sum", "none"):
        want = np.asarray(jl._reduce3(*map(jnp.asarray, (a, b, c)), 0.6, reduction))
        got = tl._reduce3(*map(torch.from_numpy, (a, b, c)), 0.6, reduction).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)


def test_bce_with_logits_matches_jax_and_torch():
    z = np.linspace(-30, 30, 61).astype(np.float32)
    t = (np.arange(61) % 2).astype(np.float32)
    want = np.asarray(jl.bce_with_logits(jnp.asarray(z), jnp.asarray(t)))
    got = tl.bce_with_logits(torch.from_numpy(z), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    torch_ref = torch.nn.functional.binary_cross_entropy_with_logits(
        torch.from_numpy(z), torch.from_numpy(t), reduction="none")
    np.testing.assert_allclose(got.numpy(), torch_ref.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("hidden", [(), (16,)])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_d_regularized_loss_with_discriminator_matches_jax(hidden, reduction):
    xs = _quad(4, D=8)
    params = jax.tree.map(np.asarray, jdisc.init_discriminator(8, jax.random.key(0), hidden))
    jmod = jdisc.PairDiscriminator(tuple(hidden))
    tmod = tdisc.PairDiscriminator(8, hidden)
    tmod.load_state_dict(tdisc.state_dict_from_flax_params(params))

    def jax_total(*args):
        return jnp.sum(jl.d_regularized_quadruplet_loss(
            *args, margin_pos_neg=1.0, margin_part_neg=0.5, lmbd=0.3,
            discr=lambda x, y: jmod.apply({"params": params}, x, y), reduction=reduction))

    want, want_g = jax.value_and_grad(jax_total, argnums=(0, 1, 2, 3))(*map(jnp.asarray, xs))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    got = tl.d_regularized_quadruplet_loss(*ts, margin_pos_neg=1.0, margin_part_neg=0.5,
                                           lmbd=0.3, discr=tmod, reduction=reduction).sum()
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **GTOL)
    for t, g in zip(ts, want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **GTOL)


def test_d_regularized_loss_with_given_logits_matches_jax():
    xs = _quad(5)
    rng = np.random.default_rng(6)
    lp, lt = (rng.standard_normal((10, 1)).astype(np.float32) for _ in range(2))
    want = jl.d_regularized_quadruplet_loss(*map(jnp.asarray, xs), discr_logits_pos=lp,
                                            discr_logits_part=lt)
    got = tl.d_regularized_quadruplet_loss(*map(torch.from_numpy, xs),
                                           discr_logits_pos=torch.from_numpy(lp),
                                           discr_logits_part=torch.from_numpy(lt))
    np.testing.assert_allclose(got.item(), float(want), **TOL)


def test_discriminator_init_is_flax_dense_init():
    """LeCun-normal kernels truncated at two standard deviations, zero
    biases: the statistics of Flax's ``Dense`` init (the bits differ)."""
    d = tdisc.init_discriminator(192, torch.Generator().manual_seed(0), (64,), device="cpu")
    w = d.hidden[0].weight
    std = (1.0 / 384) ** 0.5
    assert w.shape == (64, 384) and d.logit.weight.shape == (1, 64)
    assert abs(w.std().item() - std) < 0.1 * std
    assert w.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-6
    assert d.hidden[0].bias.abs().max().item() == 0.0 == d.logit.bias.abs().max().item()


@pytest.mark.parametrize("make", [
    lambda m: m.GammaQuadrupletLoss(gamma=1.5),
    lambda m: m.GammaQuadrupletLoss(margin_pos_part=0.0),
    lambda m: m.GammaQuadrupletLoss(p=-1.0),
    lambda m: m.GammaQuadrupletLoss(reduction="max"),
    lambda m: m.DRegularizedQuadrupletLoss(lmbd=0.0),
    lambda m: m.DRegularizedQuadrupletLoss(margin_part_neg=-1.0),
    lambda m: m.DRegularizedQuadrupletLoss(reduction="avg"),
])
def test_loss_classes_validate_like_the_source(make):
    with pytest.raises(ValueError) as want:
        make(jl)
    with pytest.raises(ValueError) as got:
        make(tl)
    assert str(got.value) == str(want.value)


def test_loss_classes_match_jax():
    xs = _quad(7)
    for jcls, tcls, extra in ((jl.GammaQuadrupletLoss, tl.GammaQuadrupletLoss, {}),
                              (jl.DRegularizedQuadrupletLoss, tl.DRegularizedQuadrupletLoss,
                               {"discr_logits_pos": np.ones((10, 1), np.float32),
                                "discr_logits_part": np.zeros((10, 1), np.float32)})):
        want = jcls()(*map(jnp.asarray, xs), reduction="sum",
                      **{k: jnp.asarray(v) for k, v in extra.items()})
        got = tcls()(*map(torch.from_numpy, xs), reduction="sum",
                     **{k: torch.from_numpy(v) for k, v in extra.items()})
        np.testing.assert_allclose(got.item(), float(want), **TOL)
    with pytest.raises(ValueError, match="discriminator"):
        tl.DRegularizedQuadrupletLoss()(*map(torch.from_numpy, xs))
