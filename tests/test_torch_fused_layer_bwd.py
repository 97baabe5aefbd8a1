"""K1 with dropout and K2, the fused layer's backward: the port's plain
versions against the TPU kernels in interpret mode.

- ``drop_mask_plain`` is bit-equal to ``_drop_mask`` (exact integer hash).
- ``fused_bert_layer_plain`` with a seed and ``nb`` against
  ``fused_bert_layer(..., interpret=True)`` with dropout: 1e-5 absolute, as
  tests/test_torch_fused_layer.py (f32 summation order and the TPU kernel's
  Abramowitz–Stegun erf, |err| ≤ 1.5e-7).
- ``fused_bert_layer_bwd_plain`` against ``_fused_layer_bwd(...,
  interpret=True)``, f32, with and without dropout, at the JAX suite's own
  tolerance for its kernel (tests/test_fused_layer.py:168-169: rtol 2e-3,
  atol 1e-5).
The JAX kernel pads the batch to a multiple of nb with fully masked rows;
the port does not, and the masks of the real rows are the same.
The CUDA kernels run only on a GPU (``cuda`` marker; skipped here).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from qst_tpu.ops import fused_layer_pallas as J
from qst_tpu_torch.ops import fused_layer as fl

B, S, H, F, NH, NB = 6, 16, 64, 128, 2, 4
BP = 8                                  # B padded to a multiple of NB, as JAX pads
TOL = dict(rtol=2e-3, atol=1e-5)


@pytest.fixture(scope="module")
def layer():
    rng = np.random.default_rng(21)

    def mat(r, c):
        return (rng.standard_normal((r, c)) * 0.05).astype(np.float32)

    def vec(n, base=0.0):
        return (base + rng.standard_normal((1, n)) * 0.05).astype(np.float32)

    w = dict(wq=mat(H, H), bq=vec(H), wk=mat(H, H), bk=vec(H), wv=mat(H, H), bv=vec(H),
             wo=mat(H, H), bo=vec(H), ln1_g=vec(H, 1.0), ln1_b=vec(H), w1=mat(H, F),
             b1=vec(F), w2=mat(F, H), b2=vec(H), ln2_g=vec(H, 1.0), ln2_b=vec(H))
    x = rng.standard_normal((B, S, H)).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[1, 9:] = 0
    mask[4, 2:] = 0
    mask[5, :] = 0                                   # a fully padded row
    bias = np.where(mask > 0, 0.0, fl.MASK_BIAS).astype(np.float32)
    g = rng.standard_normal((B, S, H)).astype(np.float32)

    def pad(a, value=0.0):
        return np.concatenate([a, np.full((BP - B,) + a.shape[1:], value, a.dtype)])

    return dict(w=w, x=x, bias=bias, g=g, jw={k: jnp.asarray(v) for k, v in w.items()},
                tw={k: torch.from_numpy(v) for k, v in w.items()}, xp=pad(x),
                bp=pad(bias, fl.MASK_BIAS), gp=pad(g))


@pytest.mark.parametrize("seed", [0, 987654321, 2**31 - 2, -123456])
@pytest.mark.parametrize("rate,tag,shape", [(0.1, 0, (128, 64)), (0.1, 1, (64, 384)),
                                            (0.5, 16 + 7, (16, 16)), (0.25, 40, (3, 77))])
def test_drop_mask_plain_is_bit_equal_to_tpu_kernel(seed, rate, tag, shape):
    want = np.asarray(J._drop_mask(shape, jnp.int32(seed), rate, tag))
    got = fl.drop_mask_plain(shape, seed, rate, tag).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert 0 < (got == 0).mean() < 1


def test_step_seed_folds_like_the_tpu_kernel():
    """``_step_seed``: seed ^ (program_id * 0x9E3779B9) in int32, the mask
    of grid step 3 being the mask under the folded seed."""
    for seed in (5, 2**31 - 1, -9):
        for blk in (0, 3, 15):
            want = int(jnp.int32(seed) ^ (jnp.int32(blk) * jnp.int32(-1640531527)))
            folded = int(np.uint32(fl.step_seed(seed, blk)).view(np.int32))
            assert folded == want
            np.testing.assert_array_equal(
                fl.drop_mask_plain((8, 8), folded, 0.1, 1).numpy(),
                np.asarray(J._drop_mask((8, 8), jnp.int32(want), 0.1, 1)))


@pytest.mark.parametrize("attn,hid", [(0.1, 0.1), (0.3, 0.0), (0.0, 0.2)])
def test_plain_forward_with_dropout_matches_tpu_kernel_interpret(layer, attn, hid):
    seed = 987
    want = np.asarray(J.fused_bert_layer(
        jnp.asarray(layer["xp"]), jnp.asarray(layer["bp"]), layer["jw"], num_heads=NH, nb=NB,
        attn_dropout=attn, hidden_dropout=hid, seed=jnp.asarray([seed], jnp.int32),
        interpret=True))[:B]
    got = fl.fused_bert_layer_plain(
        torch.from_numpy(layer["x"]), torch.from_numpy(layer["bias"]), layer["tw"],
        num_heads=NH, attn_dropout=attn, hidden_dropout=hid, seed=seed, nb=NB).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # dropout really acted: the deterministic layer differs
    plain = fl.fused_bert_layer_plain(torch.from_numpy(layer["x"]),
                                      torch.from_numpy(layer["bias"]), layer["tw"],
                                      num_heads=NH).numpy()
    assert np.abs(plain - got).max() > 1e-2


@pytest.mark.parametrize("attn,hid", [(0.0, 0.0), (0.1, 0.1), (0.2, 0.0), (0.0, 0.1)])
def test_plain_backward_matches_tpu_kernel_interpret(layer, attn, hid):
    seed = 4242
    dx, dw, _ = J._fused_layer_bwd(
        jnp.asarray(layer["xp"].reshape(BP * S, H)), jnp.asarray(layer["bp"]), layer["jw"],
        None, jnp.asarray(layer["gp"].reshape(BP * S, H)), num_heads=NH, nb=NB, eps=1e-12,
        interpret=True, attn_dropout=attn, hidden_dropout=hid,
        seed=jnp.asarray([seed], jnp.int32))
    tdx, tdw = fl.fused_bert_layer_bwd_plain(
        torch.from_numpy(layer["x"]), torch.from_numpy(layer["bias"]), layer["tw"],
        torch.from_numpy(layer["g"]), num_heads=NH, attn_dropout=attn, hidden_dropout=hid,
        seed=seed if attn or hid else None, nb=NB)
    np.testing.assert_allclose(tdx.numpy(), np.asarray(dx).reshape(BP, S, H)[:B], **TOL)
    assert list(tdw) == list(fl.WEIGHT_NAMES)
    for n in fl.WEIGHT_NAMES:
        assert tdw[n].dtype == torch.float32 and tdw[n].shape == layer["tw"][n].shape
        np.testing.assert_allclose(tdw[n].numpy(), np.asarray(dw[n]), err_msg=n, **TOL)


def test_plain_backward_is_the_autograd_gradient_of_the_plain_forward(layer):
    """Without bf16 rounding the plain backward is the exact gradient of the
    plain forward: autograd through ``fused_bert_layer_plain`` agrees."""
    x = torch.from_numpy(layer["x"]).requires_grad_(True)
    w = {k: v.clone().requires_grad_(True) for k, v in layer["tw"].items()}
    kw = dict(num_heads=NH, attn_dropout=0.1, hidden_dropout=0.1, seed=77, nb=NB)
    out = fl.fused_bert_layer_plain(x, torch.from_numpy(layer["bias"]), w, **kw)
    out.backward(torch.from_numpy(layer["g"]))
    dx, dw = fl.fused_bert_layer_bwd_plain(torch.from_numpy(layer["x"]),
                                           torch.from_numpy(layer["bias"]), layer["tw"],
                                           torch.from_numpy(layer["g"]), **kw)
    np.testing.assert_allclose(dx.numpy(), x.grad.numpy(), rtol=1e-4, atol=1e-5)
    for n in fl.WEIGHT_NAMES:
        np.testing.assert_allclose(dw[n].numpy(), w[n].grad.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=n)


def test_autograd_function_runs_the_plain_backward_on_cpu(layer):
    x = torch.from_numpy(layer["x"]).requires_grad_(True)
    w = {k: v.clone().requires_grad_(True) for k, v in layer["tw"].items()}
    bias = torch.from_numpy(layer["bias"])
    before = (fl.fused_bert_layer.launches, fl.fused_bert_layer_bwd.launches)
    out = fl.FusedBertLayer.apply(x, bias, 5, (NH, 1e-12, 0.1, 0.1, NB),
                                  *[w[n] for n in fl.WEIGHT_NAMES])
    out.backward(torch.from_numpy(layer["g"]))
    assert (fl.fused_bert_layer.launches, fl.fused_bert_layer_bwd.launches) == before
    dx, dw = fl.fused_bert_layer_bwd_plain(torch.from_numpy(layer["x"]), bias, layer["tw"],
                                           torch.from_numpy(layer["g"]), num_heads=NH,
                                           attn_dropout=0.1, hidden_dropout=0.1, seed=5, nb=NB)
    np.testing.assert_array_equal(x.grad.numpy(), dx.numpy())
    for n in fl.WEIGHT_NAMES:
        np.testing.assert_array_equal(w[n].grad.numpy(), dw[n].numpy(), err_msg=n)


def test_dropout_needs_a_seed(layer):
    with pytest.raises(ValueError, match="seed"):
        fl.fused_bert_layer_bwd(torch.from_numpy(layer["x"]), torch.from_numpy(layer["bias"]),
                                layer["tw"], torch.from_numpy(layer["g"]), num_heads=NH,
                                hidden_dropout=0.1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _cuda_layer(dev, dtype, gen, Hc=128, Fc=256):
    def mat(r, c):
        return (torch.randn((r, c), generator=gen) * 0.05).to(dev, dtype)

    def vec(n, base=0.0):
        return (base + torch.randn((1, n), generator=gen) * 0.05).to(dev)

    return dict(wq=mat(Hc, Hc), bq=vec(Hc), wk=mat(Hc, Hc), bk=vec(Hc), wv=mat(Hc, Hc),
                bv=vec(Hc), wo=mat(Hc, Hc), bo=vec(Hc), ln1_g=vec(Hc, 1.0), ln1_b=vec(Hc),
                w1=mat(Hc, Fc), b1=vec(Fc), w2=mat(Fc, Hc), b2=vec(Hc), ln2_g=vec(Hc, 1.0),
                ln2_b=vec(Hc))


@pytest.mark.cuda
def test_cuda_drop_mask_is_bit_equal_to_plain(cuda_device):
    for seed, rate, tag, shape in ((3, 0.1, 0, (256, 128)), (-7, 0.5, 30, (48, 48))):
        got = fl.drop_mask(shape, seed, rate, tag, device=cuda_device).cpu()
        assert torch.equal(got, fl.drop_mask_plain(shape, seed, rate, tag))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_cuda_k1_dropout_and_k2_match_plain(cuda_device, dtype, rate):
    """A ragged shape (B·S = 185 tokens, not a tile multiple; B not a
    multiple of nb). f32: summation order only — K1 1e-4 absolute, K2 per
    gradient max|err| <= 1e-4 max|ref|. bf16: K2 per gradient max|err| <=
    2e-2 max|ref| and mean|err| <= 2^-7 mean|ref| (chip_smoke.py's limits,
    with their reasons there)."""
    gen = torch.Generator().manual_seed(1)
    w = _cuda_layer(cuda_device, dtype, gen)
    Bc, Sc = 5, 37
    x = torch.randn((Bc, Sc, 128), generator=gen).to(cuda_device, dtype)
    bias = torch.zeros((Bc, Sc))
    bias[-1] = fl.MASK_BIAS
    bias[0, 20:] = fl.MASK_BIAS
    bias = bias.to(cuda_device)
    g = torch.randn((Bc, Sc, 128), generator=gen).to(cuda_device, dtype)
    kw = dict(num_heads=4, attn_dropout=rate, hidden_dropout=rate,
              seed=11 if rate else None, nb=3)
    out = fl.fused_bert_layer(x, bias, w, **kw).float()
    ref = fl.fused_bert_layer_plain(x, bias, w, **kw).float()
    k1_lim = 1e-4 if dtype == torch.float32 else 2e-2 * ref.abs().max().item()
    assert (out - ref).abs().max().item() <= k1_lim
    dx, dw = fl.fused_bert_layer_bwd(x, bias, w, g, **kw)
    rdx, rdw = fl.fused_bert_layer_bwd_plain(x, bias, w, g, **kw)
    lim_max, lim_mean = (1e-4, 2e-5) if dtype == torch.float32 else (2e-2, 2.0 ** -7)
    for n, (a, b) in dict(dx=(dx, rdx), **{k: (dw[k], rdw[k]) for k in dw}).items():
        assert torch.isfinite(a).all(), n
        d = (a.float() - b.float()).abs()
        scale = (rdw["bq"] if n == "bk" else b).float().abs()
        assert d.max().item() <= lim_max * scale.max().item(), n
        assert d.mean().item() <= lim_mean * scale.mean().item(), n
