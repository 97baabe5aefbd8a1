"""K1, the fused BERT layer: the port's plain version against the TPU kernel
(``fused_bert_layer(..., interpret=True)``) and the Flax ``BertLayer``.

Same weights (JAX ``init_params`` → ``state_dict_from_flax_params``) and the
same numpy inputs go through both packages at f32. Tolerance 1e-5 absolute
on LayerNorm outputs of order 1: the summation order differs, and the TPU
kernel's erf is the Abramowitz–Stegun approximation (|err| ≤ 1.5e-7).
The kernel itself runs only on a GPU (``cuda`` marker; skipped here).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qst_tpu.core.config import EncoderConfig as JaxConfig
from qst_tpu.models.bert import BertLayer as FlaxBertLayer
from qst_tpu.models.sentence_encoder import init_params as jax_init_params
from qst_tpu.ops.fused_layer_pallas import fused_bert_layer as jax_fused_bert_layer
from qst_tpu.ops.fused_layer_pallas import layer_weights_from_params
from qst_tpu_torch.core.config import EncoderConfig
from qst_tpu_torch.models.hf_import import state_dict_from_flax_params
from qst_tpu_torch.models.sentence_encoder import SentenceEncoderModule
from qst_tpu_torch.ops import fused_layer as fl

ATOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    jcfg = JaxConfig.tiny(hidden_size=64, num_heads=2)   # head_dim 32
    cfg = EncoderConfig(**dataclasses.asdict(jcfg))
    params = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.key(3)))
    model = SentenceEncoderModule(cfg)
    model.load_state_dict(state_dict_from_flax_params(params, cfg))
    rng = np.random.default_rng(5)
    B, S = 4, 16
    x = rng.standard_normal((B, S, cfg.hidden_size)).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[1, 9:] = 0
    mask[2, 3:] = 0
    mask[3, :] = 0                                   # a fully padded row
    bias = np.where(mask > 0, 0.0, fl.MASK_BIAS).astype(np.float32)
    return dict(jcfg=jcfg, cfg=cfg, params=params, model=model, x=x, mask=mask, bias=bias)


def _port_plain(s, layer=0):
    w = fl.layer_weights_from_module(s["model"].encoder.layer[layer], torch.float32)
    return fl.fused_bert_layer_plain(torch.from_numpy(s["x"]), torch.from_numpy(s["bias"]),
                                     w, num_heads=s["cfg"].num_heads).numpy()


@pytest.mark.parametrize("layer", [0, 1])
def test_kernel_layout_weights_match_jax(setup, layer):
    want = layer_weights_from_params(setup["params"]["encoder"][f"layer_{layer}"],
                                     setup["cfg"].hidden_size, jnp.float32)
    got = fl.layer_weights_from_module(setup["model"].encoder.layer[layer], torch.float32)
    assert list(got) == list(fl.WEIGHT_NAMES) + ["wqkv", "bqkv"]
    for n in fl.WEIGHT_NAMES:
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]), err_msg=n)
    for n, parts in (("wqkv", ("wq", "wk", "wv")), ("bqkv", ("bq", "bk", "bv"))):
        np.testing.assert_array_equal(
            got[n].numpy(), np.concatenate([np.asarray(want[p]) for p in parts], 1), err_msg=n)


@pytest.mark.parametrize("layer", [0, 1])
def test_plain_matches_tpu_kernel_interpret(setup, layer):
    w = layer_weights_from_params(setup["params"]["encoder"][f"layer_{layer}"],
                                  setup["cfg"].hidden_size, jnp.float32)
    want = np.asarray(jax_fused_bert_layer(
        jnp.asarray(setup["x"]), jnp.asarray(setup["bias"]), w,
        num_heads=setup["cfg"].num_heads, nb=4, interpret=True))
    got = _port_plain(setup, layer)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _random_case(S, num_heads, seed, B=4, H=64, F=128):
    """Numpy-seeded weights (tiny widths) and a batch whose last sequence is
    fully padded and whose second is half padded."""
    rng = np.random.default_rng(seed)

    def mat(r, c):
        return (rng.standard_normal((r, c)) * 0.05).astype(np.float32)

    def vec(n, base=0.0):
        return (base + rng.standard_normal((1, n)) * 0.05).astype(np.float32)

    w = dict(wq=mat(H, H), bq=vec(H), wk=mat(H, H), bk=vec(H), wv=mat(H, H), bv=vec(H),
             wo=mat(H, H), bo=vec(H), ln1_g=vec(H, 1.0), ln1_b=vec(H), w1=mat(H, F),
             b1=vec(F), w2=mat(F, H), b2=vec(H), ln2_g=vec(H, 1.0), ln2_b=vec(H))
    x = rng.standard_normal((B, S, H)).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[1, S // 2:] = 0
    mask[-1, :] = 0
    bias = np.where(mask > 0, 0.0, fl.MASK_BIAS).astype(np.float32)
    return w, x, bias


@pytest.mark.parametrize("S", [24, 40])
@pytest.mark.parametrize("num_heads", [4, 2, 1])   # head widths 16, 32 and 64
def test_plain_matches_tpu_kernel_interpret_at_the_attention_edges(S, num_heads):
    """Sequence lengths that are no multiple of 16, the three head widths the
    CUDA attention takes, a fully padded sequence: the shapes at which the
    tensor-core attention pads its key columns."""
    w, x, bias = _random_case(S, num_heads, seed=31 + S + num_heads)
    want = np.asarray(jax_fused_bert_layer(
        jnp.asarray(x), jnp.asarray(bias), {k: jnp.asarray(v) for k, v in w.items()},
        num_heads=num_heads, nb=2, interpret=True))
    got = fl.fused_bert_layer_plain(torch.from_numpy(x), torch.from_numpy(bias),
                                    {k: torch.from_numpy(v) for k, v in w.items()},
                                    num_heads=num_heads).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("trans_a", [False, True])
@pytest.mark.parametrize("trans_b", [False, True])
def test_layer_gemm_plain_matches_jax_product(trans_a, trans_b):
    """The layer's GEMM alone, in its four operand layouts, against the JAX
    product of the same bf16 numpy operands in f32 (exact products, f32
    sums: 1e-5 of the largest output for the order of the sums). On the CPU
    the wrapper is the plain version and launches nothing."""
    rng = np.random.default_rng(7)
    M, N, K = 40, 64, 72
    a = torch.from_numpy(rng.standard_normal((K, M) if trans_a else (M, K)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((N, K) if trans_b else (K, N)).astype(np.float32))
    a, b = a.bfloat16(), b.bfloat16()
    ja, jb = jnp.asarray(a.float().numpy()), jnp.asarray(b.float().numpy())
    want = np.asarray(jnp.dot(ja.T if trans_a else ja, jb.T if trans_b else jb,
                              precision=jax.lax.Precision.HIGHEST))
    before = fl.layer_gemm.launches
    got = fl.layer_gemm(a, b, trans_a=trans_a, trans_b=trans_b, splits=3)
    assert fl.layer_gemm.launches == before
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(
        got.numpy(), fl.layer_gemm_plain(a, b, trans_a=trans_a, trans_b=trans_b).numpy())


def test_plain_and_module_match_flax_bert_layer(setup):
    flax_layer = FlaxBertLayer(setup["jcfg"])
    p = setup["params"]["encoder"]["layer_0"]
    bias4 = jnp.asarray(setup["bias"])[:, None, None, :]
    want = np.asarray(flax_layer.apply({"params": p}, jnp.asarray(setup["x"]), bias4,
                                       jnp.asarray(setup["mask"]), True))
    np.testing.assert_allclose(_port_plain(setup), want, rtol=0, atol=ATOL)
    module = setup["model"].encoder.layer[0]
    with torch.no_grad():
        got = module(torch.from_numpy(setup["x"]),
                     torch.from_numpy(setup["bias"])[:, None, None, :]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_wrapper_takes_the_plain_version_on_cpu(setup):
    w = fl.layer_weights_from_module(setup["model"].encoder.layer[0], torch.float32)
    before = fl.fused_bert_layer.launches
    out = fl.fused_bert_layer(torch.from_numpy(setup["x"]), torch.from_numpy(setup["bias"]),
                              w, num_heads=setup["cfg"].num_heads)
    assert fl.fused_bert_layer.launches == before
    np.testing.assert_array_equal(out.numpy(), _port_plain(setup))


@pytest.mark.parametrize("kwargs", [dict(rel_bias=torch.zeros(1)), dict(attn_dropout=0.1),
                                    dict(hidden_dropout=0.1)])
def test_unported_options_raise(setup, kwargs):
    """MPNet's relative bias is not ported; dropout is, and needs a seed
    (the TPU kernel's ValueError)."""
    w = fl.layer_weights_from_module(setup["model"].encoder.layer[0], torch.float32)
    exc = NotImplementedError if "rel_bias" in kwargs else ValueError
    with pytest.raises(exc):
        fl.fused_bert_layer(torch.from_numpy(setup["x"]), torch.from_numpy(setup["bias"]),
                            w, num_heads=2, **kwargs)


def test_kernel_weight_cache_follows_the_parameters(setup):
    model = SentenceEncoderModule(setup["cfg"])
    layer = model.encoder.layer[0]
    w1 = fl.layer_weights_from_module(layer, torch.float32)
    assert fl.layer_weights_from_module(layer, torch.float32) is w1   # cached
    assert fl.layer_weights_from_module(layer, torch.bfloat16)["wq"].dtype == torch.bfloat16
    model.load_state_dict(state_dict_from_flax_params(setup["params"], setup["cfg"]))
    w2 = fl.layer_weights_from_module(layer, torch.float32)
    np.testing.assert_array_equal(w2["wq"].numpy(),
                                  layer.attention.self.query.weight.detach().T.numpy())
    assert not torch.equal(w1["wq"], w2["wq"])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _bf16_limits(out, ref):
    """bf16 K1 against its plain version: summation order flips roundings at
    the cast points. Bounds as in chip_smoke.py: max, per element (two bf16
    ulps, floor one ulp at 1) and mean (a dropped rounding point raises it
    about tenfold)."""
    diff = (out - ref).abs()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(2.0 ** -126))) - 7)
    assert diff.max().item() <= 2e-2 * ref.abs().max().item()
    assert (diff <= 2 * (ulp + 2.0 ** -7)).all()
    assert diff.mean().item() <= 2.0 ** -10 * ref.abs().mean().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain(cuda_device, dtype):
    gen = torch.Generator().manual_seed(0)
    H, F, nh, B, S = 128, 256, 4, 8, 48

    def mat(r, c):
        return (torch.randn((r, c), generator=gen) * 0.05).to(cuda_device, dtype)

    def vec(n, base=0.0):
        return (base + torch.randn((1, n), generator=gen) * 0.05).to(cuda_device)

    w = dict(wq=mat(H, H), bq=vec(H), wk=mat(H, H), bk=vec(H), wv=mat(H, H), bv=vec(H),
             wo=mat(H, H), bo=vec(H), ln1_g=vec(H, 1.0), ln1_b=vec(H), w1=mat(H, F),
             b1=vec(F), w2=mat(F, H), b2=vec(H), ln2_g=vec(H, 1.0), ln2_b=vec(H))
    x = torch.randn((B, S, H), generator=gen).to(cuda_device, dtype)
    bias = torch.zeros((B, S))
    bias[-1] = fl.MASK_BIAS
    bias[0, 20:] = fl.MASK_BIAS
    bias = bias.to(cuda_device)
    out = fl.fused_bert_layer(x, bias, w, num_heads=nh).float()
    ref = fl.fused_bert_layer_plain(x, bias, w, num_heads=nh).float()
    assert torch.isfinite(out).all()
    if dtype == torch.float32:
        assert (out - ref).abs().max().item() <= 1e-4
    else:
        _bf16_limits(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [24, 40, 77])
@pytest.mark.parametrize("num_heads", [4, 2])   # head widths 32 and 64 at H = 128
def test_cuda_kernel_matches_plain_at_the_attention_edges(cuda_device, S, num_heads):
    """bf16 K1 where its tensor-core attention pads: S no multiple of 16,
    both head widths, a fully padded and a half padded sequence."""
    w, x, bias = _random_case(S, num_heads, seed=S + num_heads, B=5, H=128, F=256)
    w = {k: torch.from_numpy(v).to(cuda_device, torch.bfloat16 if v.shape[0] > 1
                                   else torch.float32) for k, v in w.items()}
    x = torch.from_numpy(x).to(cuda_device, torch.bfloat16)
    bias = torch.from_numpy(bias).to(cuda_device)
    out = fl.fused_bert_layer(x, bias, w, num_heads=num_heads).float()
    assert torch.isfinite(out).all()
    _bf16_limits(out, fl.fused_bert_layer_plain(x, bias, w, num_heads=num_heads).float())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [32, 21])
def test_cuda_kernel_matches_plain_at_head_width_16(cuda_device, dtype, S):
    """K1 at ``EncoderConfig.tiny()``'s shapes (H = 64, 4 heads of width
    16, F = 128), f32 and bf16, at the tiny preset's S = 32 and a ragged S,
    at the limits of test_cuda_kernel_matches_plain."""
    w, x, bias = _random_case(S, 4, seed=S, B=6, H=64, F=128)
    w = {k: torch.from_numpy(v).to(cuda_device, dtype if v.shape[0] > 1 else torch.float32)
         for k, v in w.items()}
    x = torch.from_numpy(x).to(cuda_device, dtype)
    bias = torch.from_numpy(bias).to(cuda_device)
    out = fl.fused_bert_layer(x, bias, w, num_heads=4).float()
    ref = fl.fused_bert_layer_plain(x, bias, w, num_heads=4).float()
    assert torch.isfinite(out).all()
    if dtype == torch.float32:
        assert (out - ref).abs().max().item() <= 1e-4
    else:
        _bf16_limits(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [128, 256, 384, 1152, 1536])
@pytest.mark.parametrize("trans_a,trans_b", [(False, False), (False, True), (True, False),
                                             (True, True)])
def test_cuda_layer_gemm_matches_plain(cuda_device, N, trans_a, trans_b):
    """The bf16 GEMM alone: M no multiple of its 128-row tile, every N the
    layer uses, each operand layout, with and without split-K. bf16
    products are exact in f32, so only the order of the f32 sums differs:
    2e-5 of max|ref| (chip_smoke.py's limit)."""
    gen = torch.Generator().manual_seed(N + 2 * trans_a + trans_b)
    M, K = 1000, 384

    def rnd(*shape):
        return (torch.randn(shape, generator=gen) * 0.5).to(cuda_device, torch.bfloat16)

    a = rnd(K, M) if trans_a else rnd(M, K)
    b = rnd(N, K) if trans_b else rnd(K, N)
    ref = fl.layer_gemm_plain(a, b, trans_a=trans_a, trans_b=trans_b)
    for splits in (1, 3):
        before = fl.layer_gemm.launches
        out = fl.layer_gemm(a, b, trans_a=trans_a, trans_b=trans_b, splits=splits)
        assert fl.layer_gemm.launches == before + 1
        assert ((out - ref).abs().max() / ref.abs().max()).item() <= 2e-5
