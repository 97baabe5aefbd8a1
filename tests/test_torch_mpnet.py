"""MPNet in the port, and K1/K2 beyond S = 128, against qst_tpu.

- ``relative_position_bucket`` and the padding-aware positions exactly;
- the port's ``MPNetEncoder`` (through ``SentenceEncoderModule``) against
  JAX's, f32, at ``tests/test_fused_layer.py``'s MPNet config, 1e-5;
- K1's plain version with ``rel_bias`` against the TPU kernel
  (``fused_bert_layer(..., interpret=True)``), 1e-5 absolute;
- K2's plain version (dx, 16 weight gradients and ``drel``) against
  ``_fused_layer_bwd`` in interpret mode, 1e-5 of each tensor's largest
  value, with dropout too;
- BERT and MPNet layers at S = 160 and 256, forward and backward, against
  the interpret kernels at a tiny width (the key-blocked path's lengths);
- the fused MPNet encoder against JAX's fused path and the module path;
- one MPNet train step against JAX ``make_train_step``, and
  ``steps_per_call=2`` equal to two single steps bit for bit;
- both packages give the same ids for an MPNet ``vocab.txt`` (a known
  difference with HF, ROADMAP C).

The same weights (JAX ``init_params`` → ``state_dict_from_flax_params``)
and numpy inputs go through both packages. Tests of the kernels themselves
need a GPU (``cuda`` marker) and skip here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qst_tpu.core import config as jc
from qst_tpu.models import mpnet as jmpnet
from qst_tpu.models.sentence_encoder import SentenceEncoderModule as JaxModule
from qst_tpu.models.sentence_encoder import init_params as jax_init_params
from qst_tpu.ops.fused_layer_pallas import _fused_layer_bwd as jax_layer_bwd
from qst_tpu.ops.fused_layer_pallas import fused_bert_layer as jax_layer
from qst_tpu.ops.fused_layer_pallas import fused_embed_fn as jax_fused_embed_fn
from qst_tpu.train import train_step as jts
from qst_tpu_torch.core import config as tc
from qst_tpu_torch.models import mpnet as tmpnet
from qst_tpu_torch.models.hf_import import state_dict_from_flax_params
from qst_tpu_torch.models.sentence_encoder import SentenceEncoderModule, embed_fn
from qst_tpu_torch.ops import fused_layer as fl
from qst_tpu_torch.train import train_step as tts

ATOL = 1e-5


def _mpnet_cfg(**over):
    """tests/test_fused_layer.py:84-89's MPNet config."""
    base = dict(name="t-mpnet", arch="mpnet", vocab_size=512, hidden_size=128, num_layers=2,
                num_heads=4, intermediate_size=256, max_position_embeddings=66,
                max_seq_length=32, dtype="float32", pad_token_id=1)
    base.update(over)
    jcfg = jc.EncoderConfig(**base)
    return jcfg, tc.EncoderConfig(**dataclasses.asdict(jcfg))


def _ids(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, cfg.vocab_size, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    for i in range(B):
        n = int(rng.integers(2, S + 1))
        ids[i, n:] = cfg.pad_token_id
        mask[i, n:] = 0
    return ids, mask


@pytest.fixture(scope="module")
def mpnet():
    jcfg, cfg = _mpnet_cfg()
    params = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.key(4)))
    model = SentenceEncoderModule(cfg)
    model.load_state_dict(state_dict_from_flax_params(params, cfg))
    model.eval()
    return jcfg, cfg, params, model


def test_relative_position_bucket_is_the_source_exactly():
    rel = np.arange(-600, 601, dtype=np.int32)
    want = np.asarray(jmpnet.relative_position_bucket(jnp.asarray(rel)))
    got = tmpnet.relative_position_bucket(torch.from_numpy(rel).long()).numpy()
    np.testing.assert_array_equal(got, want)
    S = 300
    pos = np.arange(S)
    want_table = np.asarray(jmpnet.relative_position_bucket(
        jnp.asarray(pos[None, :] - pos[:, None])))
    np.testing.assert_array_equal(tmpnet.position_buckets(S, "cpu").numpy(), want_table)


@pytest.mark.parametrize("pad_id", [0, 1])
def test_padding_aware_positions_are_the_source_exactly(pad_id):
    _, cfg = _mpnet_cfg()
    ids, _ = _ids(cfg, 5, 24, seed=pad_id)
    ids[2, :3] = pad_id                       # leading pads too
    want = np.asarray(jmpnet.padding_aware_position_ids(jnp.asarray(ids), pad_id))
    got = tmpnet.padding_aware_position_ids(torch.from_numpy(ids).long(), pad_id).numpy()
    np.testing.assert_array_equal(got, want)


def test_state_dict_names_are_hf_mpnet(mpnet):
    from qst_tpu.models.hf_export import export_mpnet_state_dict

    jcfg, cfg, params, model = mpnet
    assert set(model.state_dict()) == set(export_mpnet_state_dict(params, jcfg))


def test_encoder_matches_jax_mpnet(mpnet):
    jcfg, cfg, params, model = mpnet
    ids, mask = _ids(cfg, 6, 32, seed=4)
    want = JaxModule(jcfg).apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask))
    for key in ("token_embeddings", "sentence_embedding"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=ATOL,
                                   err_msg=key)


def test_fused_encoder_matches_jax_fused_and_module(mpnet):
    jcfg, cfg, params, model = mpnet
    ids, mask = _ids(cfg, 6, 32, seed=5)
    want = np.asarray(jax_fused_embed_fn(jcfg, nb=2, interpret=True)(
        params, jnp.asarray(ids), jnp.asarray(mask)))
    fused = embed_fn(dataclasses.replace(cfg, use_fused_layer=True))
    got = fused(model, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    plain = embed_fn(cfg)(model, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, plain, rtol=0, atol=ATOL)


def _layer_case(arch, S, B=3, seed=0):
    """A random layer in both layouts, inputs with padded and fully padded
    rows and (MPNet) a relative bias gathered from a random table."""
    rng = np.random.default_rng(seed)
    H, F, nh = (64, 128, 4) if arch == "mpnet" else (64, 128, 2)
    w = {}
    for n, shape in (("wq", (H, H)), ("wk", (H, H)), ("wv", (H, H)), ("wo", (H, H)),
                     ("w1", (H, F)), ("w2", (F, H))):
        w[n] = (rng.standard_normal(shape) * 0.08).astype(np.float32)
    for n, size in (("bq", H), ("bk", H), ("bv", H), ("bo", H), ("b1", F), ("b2", H),
                    ("ln1_b", H), ("ln2_b", H)):
        w[n] = (rng.standard_normal((1, size)) * 0.05).astype(np.float32)
    for n in ("ln1_g", "ln2_g"):
        w[n] = (1.0 + rng.standard_normal((1, H)) * 0.05).astype(np.float32)
    x = rng.standard_normal((B, S, H)).astype(np.float32)
    mask = np.ones((B, S), np.float32)
    mask[1, S // 3:] = 0
    mask[-1] = 0
    bias = np.where(mask > 0, 0.0, fl.MASK_BIAS).astype(np.float32)
    g = rng.standard_normal((B, S, H)).astype(np.float32)
    rel = None
    if arch == "mpnet":
        table = (rng.standard_normal((32, nh)) * 0.5).astype(np.float32)
        rel = tmpnet.relative_bias(torch.from_numpy(table), S).reshape(nh * S, S).numpy()
    return dict(w=w, x=x, bias=bias, g=g, rel=rel, nh=nh)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _check_layer(case, drop, nb):
    kw = dict(attn_dropout=drop, hidden_dropout=drop)
    seed = 77 if drop else None
    want = np.asarray(jax_layer(
        jnp.asarray(case["x"]), jnp.asarray(case["bias"]),
        {k: jnp.asarray(v) for k, v in case["w"].items()}, num_heads=case["nh"],
        rel_bias=None if case["rel"] is None else jnp.asarray(case["rel"]), nb=nb,
        seed=None if seed is None else jnp.asarray([seed], jnp.int32), interpret=True, **kw))
    tw = {k: _t(v) for k, v in case["w"].items()}
    got = fl.fused_bert_layer(_t(case["x"]), _t(case["bias"]), tw, num_heads=case["nh"],
                              rel_bias=_t(case["rel"]), seed=seed, nb=nb, **kw).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    B, S, H = case["x"].shape
    jdx, jdw, jdrel = jax_layer_bwd(
        jnp.asarray(case["x"].reshape(B * S, H)), jnp.asarray(case["bias"]),
        {k: jnp.asarray(v) for k, v in case["w"].items()},
        None if case["rel"] is None else jnp.asarray(case["rel"]),
        jnp.asarray(case["g"].reshape(B * S, H)), num_heads=case["nh"], nb=nb, eps=1e-12,
        interpret=True, seed=None if seed is None else jnp.asarray([seed], jnp.int32), **kw)
    dx, dw = fl.fused_bert_layer_bwd(_t(case["x"]), _t(case["bias"]), tw, _t(case["g"]),
                                     num_heads=case["nh"], rel_bias=_t(case["rel"]),
                                     seed=seed, nb=nb, **kw)
    want_all = dict({k: np.asarray(v) for k, v in jdw.items()},
                    dx=np.asarray(jdx).reshape(B, S, H))
    got_all = dict({k: v.numpy() for k, v in dw.items()}, dx=dx.numpy())
    if case["rel"] is not None:
        want_all["drel"] = np.asarray(jdrel)
    assert set(got_all) == set(want_all)
    for k, v in want_all.items():
        scale = np.abs(want_all["bq"] if k == "bk" else v).max()
        np.testing.assert_allclose(got_all[k], v, rtol=0, atol=1e-5 * scale, err_msg=k)


@pytest.mark.parametrize("drop", [0.0, 0.1])
def test_layer_with_rel_bias_matches_the_tpu_kernels(drop):
    """K1 with ``rel_bias`` and K2 with ``drel``, plain versions against the
    TPU kernels in interpret mode at S = 32, with and without dropout."""
    _check_layer(_layer_case("mpnet", 32, B=4, seed=1), drop, nb=2)


@pytest.mark.parametrize("S", [160, 256])
@pytest.mark.parametrize("arch", ["bert", "mpnet"])
def test_long_layers_match_the_tpu_kernels(arch, S):
    """The key-blocked path's lengths: forward and backward of a BERT and an
    MPNet layer at S = 160 and 256 against the interpret kernels."""
    _check_layer(_layer_case(arch, S, B=2, seed=S), 0.0, nb=2)


@pytest.mark.parametrize("S", [1, 5, 33, 130])
def test_relative_bias_gradient_sums_the_buckets(S):
    """The table's gradient through ``relative_bias`` (diagonal sums, then
    per bucket) equals F.embedding's autograd gradient; the bias itself is
    the gather."""
    rng = np.random.default_rng(S)
    table = torch.from_numpy(rng.standard_normal((32, 4)).astype(np.float64))
    g = torch.from_numpy(rng.standard_normal((4, S, S)))
    t1, t2 = table.clone().requires_grad_(True), table.clone().requires_grad_(True)
    got = tmpnet.relative_bias(t1, S)
    (got * g).sum().backward()
    want = torch.nn.functional.embedding(tmpnet.position_buckets(S, "cpu"), t2).permute(2, 0, 1)
    (want * g).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), want.detach().float().numpy())
    np.testing.assert_allclose(t1.grad.numpy(), t2.grad.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pad_id", [0, 1])
def test_position_embeddings_gradient_is_f_embedding_s(pad_id):
    """Padding-aware positions, pads at the end, inside and at the start of
    a sequence, and a sequence of pads only."""
    rng = np.random.default_rng(3 + pad_id)
    w = torch.from_numpy(rng.standard_normal((36, 8)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(2, 50, (5, 30)))
    ids[0, 20:] = pad_id
    ids[1, 3:6] = pad_id
    ids[2, :4] = pad_id
    ids[3] = pad_id
    g = torch.from_numpy(rng.standard_normal((5, 30, 8)).astype(np.float32))
    w1, w2 = w.clone().requires_grad_(True), w.clone().requires_grad_(True)
    got = tmpnet.position_embeddings(ids, w1, pad_id)
    (got * g).sum().backward()
    want = torch.nn.functional.embedding(tmpnet.padding_aware_position_ids(ids, pad_id), w2)
    (want * g).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), want.detach().numpy())
    np.testing.assert_allclose(w1.grad.numpy(), w2.grad.numpy(), rtol=1e-6, atol=1e-6)


def test_rel_bias_shape_is_checked():
    case = _layer_case("mpnet", 32, B=2)
    with pytest.raises(ValueError, match="rel_bias"):
        fl.fused_bert_layer(_t(case["x"]), _t(case["bias"]),
                            {k: _t(v) for k, v in case["w"].items()}, num_heads=case["nh"],
                            rel_bias=torch.zeros(4, 32))


def test_fused_rel_bias_gradient_reaches_the_table(mpnet):
    """On the fused training path the relative-bias table's gradient is the
    sum of every layer's ``drel`` through the F.embedding gather: equal to
    the module path's autograd gradient."""
    jcfg, cfg, params, model = mpnet
    ids, mask = _ids(cfg, 4, 32, seed=9)
    grads = {}
    for fused in (False, True):
        model.zero_grad()
        c = dataclasses.replace(cfg, use_fused_layer=fused)
        emb = tts.encoder_apply_fn(c)(model, torch.from_numpy(ids).long(),
                                      torch.from_numpy(mask).long(), None)
        (emb * torch.linspace(-1, 1, emb.numel()).reshape(emb.shape)).sum().backward()
        grads[fused] = {n: p.grad.clone() for n, p in model.named_parameters()}
    name = "encoder.relative_attention_bias.weight"
    scale = grads[False][name].abs().max().item()
    assert scale > 0
    for n in grads[False]:
        # the key bias's gradient is zero up to rounding (softmax ignores a
        # constant added to a row): held to the query bias's scale
        ref = n.replace("attn.k.bias", "attn.q.bias")
        s = grads[False][ref].abs().max().item()
        np.testing.assert_allclose(grads[True][n].numpy(), grads[False][n].numpy(), rtol=0,
                                   atol=1e-4 * max(s, 1e-12), err_msg=n)


# ---------------------------------------------------------------- training
B_TRAIN = 4
LR = 1e-3


def _train_configs(fused):
    jcfg, _ = _mpnet_cfg(hidden_dropout=0.0, attention_dropout=0.0, use_fused_layer=fused)
    jl = jc.LossConfig(margin_pos_part=0.5, margin_part_neg=0.5, use_fused_kernel=fused)
    jt = jc.TrainConfig(batch_size=B_TRAIN, learning_rate=LR, scheduler="constantlr",
                        max_grad_norm=0.5)
    to_t = lambda cls, c: cls(**dataclasses.asdict(c))  # noqa: E731
    return (jcfg, jl, jt), (to_t(tc.EncoderConfig, jcfg), to_t(tc.LossConfig, jl),
                            to_t(tc.TrainConfig, jt))


def _quad_batch(cfg, seed):
    ids, mask = _ids(cfg, 4 * B_TRAIN, cfg.max_seq_length, seed)
    S = cfg.max_seq_length
    return ids.reshape(4, B_TRAIN, S), mask.reshape(4, B_TRAIN, S)


@pytest.mark.parametrize("fused", [False, True], ids=["module", "fused"])
def test_mpnet_train_step_matches_jax_make_train_step(fused):
    (jcfg, jl, jt), (tcfg, tl, tt) = _train_configs(fused)
    params = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.key(0)))
    sj, tx = jts.create_train_state(jcfg, jt, jax.random.key(0), 10, jl, initial_params=params)
    st, _ = tts.create_train_state(tcfg, tt, torch.Generator().manual_seed(0), 10, tl,
                                   initial_params=state_dict_from_flax_params(params, tcfg),
                                   device="cpu")
    ids, mask = _quad_batch(tcfg, 3)
    sj, lj = jts.make_train_step(jcfg, jl, tx)(sj, jnp.asarray(ids), jnp.asarray(mask),
                                               jax.random.key(1))
    st, lt = tts.make_train_step(tcfg, tl)(st, ids, mask, None)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    want = state_dict_from_flax_params(jax.tree.map(np.asarray, sj.params), tcfg)
    got = st.model.state_dict()
    for k, v in want.items():
        atol = 2 * LR if k.endswith("attention.attn.k.bias") else 0.1 * LR
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=atol, err_msg=k)


def test_mpnet_two_steps_per_call_equal_two_single_steps():
    """With dropout 0.1 on the fused path: K = 2 steps in one call are two
    single steps bit for bit (losses, parameters, moments)."""
    _, cfg = _mpnet_cfg(use_fused_layer=True)
    loss_cfg = tc.LossConfig(margin_pos_part=0.5, margin_part_neg=0.5, use_fused_kernel=True)
    tcfg = tc.TrainConfig(learning_rate=LR, warmup_steps=2)
    pairs = [_quad_batch(cfg, 20 + j) for j in range(2)]
    ids, mask = np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])
    keys = torch.stack([tts.dropout_key(5, s) for s in (1, 2)])
    multi, _ = tts.create_train_state(cfg, tcfg, torch.Generator().manual_seed(1), 10, loss_cfg,
                                      device="cpu")
    multi, losses = tts.make_multi_step(cfg, loss_cfg, None, 2)(multi, ids, mask, keys)
    single, _ = tts.create_train_state(cfg, tcfg, torch.Generator().manual_seed(1), 10,
                                       loss_cfg, device="cpu")
    step = tts.make_train_step(cfg, loss_cfg)
    singles = []
    for j in range(2):
        single, loss = step(single, ids[j], mask[j], keys[j])
        singles.append(loss)
    assert torch.equal(losses, torch.stack(singles))
    for a, b in zip(multi.optimizer.state_tensors(), single.optimizer.state_tensors()):
        assert torch.equal(a, b)


def test_both_packages_frame_mpnet_inputs_alike(tmp_path):
    """Known difference with HF (ROADMAP C): both packages frame an MPNet
    ``vocab.txt``'s inputs with [CLS] / [SEP] and pad with [PAD], not
    ``<s>`` / ``</s>`` / ``<pad>`` — and give the same ids."""
    from qst_tpu.models.tokenizer import load_tokenizer as jload
    from qst_tpu_torch.models.tokenizer import load_tokenizer as tload

    words = ["<s>", "<pad>", "</s>", "<unk>", "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
             "the", "cat", "sat", "on", "mat", "##s", "a", "dog"]
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(words) + "\n")
    texts = ["the cat sat on the mat", "a dog", "cats"]
    jids, jmask = jload(str(path), vocab_size=len(words)).batch_encode(texts, max_length=12)
    tids, tmask = tload(str(path), vocab_size=len(words)).batch_encode(texts, max_length=12)
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_array_equal(tmask, jmask)
    assert tids[0, 0] == words.index("[CLS]") and tids[1, 3] == words.index("[SEP]")
    assert tids[1, -1] == words.index("[PAD]")


# ---------------------------------------------------------------- the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _cuda_case(arch, S, dtype, dev, B=4):
    c = _layer_case(arch, S, B=B, seed=S + 1)
    w = {k: _t(v).to(dev, dtype if k in ("wq", "wk", "wv", "wo", "w1", "w2") else torch.float32)
         for k, v in c["w"].items()}
    return (c, w, _t(c["x"]).to(dev, dtype), _t(c["bias"]).to(dev), _t(c["g"]).to(dev, dtype),
            None if c["rel"] is None else _t(c["rel"]).to(dev))


@pytest.mark.cuda
def test_cuda_relative_bias_gradient_repeats(cuda_device):
    """The table's gradient is the same bits from call to call on the card
    (F.embedding's own backward is not, for 32 rows and S² ids)."""
    table = torch.randn(32, 12, device=cuda_device)
    g = torch.randn(12, 384, 384, device=cuda_device)
    grads = [torch.autograd.grad((tmpnet.relative_bias(table.requires_grad_(True), 384)
                                  * g).sum(), table)[0] for _ in range(3)]
    assert all(torch.equal(grads[0], x) for x in grads[1:])


@pytest.mark.cuda
def test_cuda_sequences_past_512_raise(cuda_device):
    case = _layer_case("bert", 16, B=2)
    with pytest.raises(NotImplementedError, match="512"):
        fl.fused_bert_layer(torch.zeros((1, 520, 64), device=cuda_device),
                            torch.zeros((1, 520), device=cuda_device),
                            {k: _t(v).to(cuda_device) for k, v in case["w"].items()},
                            num_heads=2)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,S", [("mpnet", 32), ("mpnet", 200), ("bert", 200),
                                    ("mpnet", 512)])
def test_cuda_k1_matches_plain(cuda_device, arch, S):
    """K1 (f32) with ``rel_bias`` and beyond S = 128 against its plain
    version on the card, 1e-4 absolute."""
    c, w, x, bias, _, rel = _cuda_case(arch, S, torch.float32, cuda_device)
    kw = dict(num_heads=c["nh"], rel_bias=rel, attn_dropout=0.1, hidden_dropout=0.1, seed=3)
    out = fl.fused_bert_layer(x, bias, w, **kw)
    ref = fl.fused_bert_layer_plain(x, bias, w, **kw)
    assert (out - ref).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("arch,S", [("mpnet", 32), ("mpnet", 200), ("bert", 300)])
def test_cuda_k2_drel_matches_plain_and_repeats(cuda_device, arch, S):
    """K2 (f32) with ``drel`` and beyond S = 128: each gradient within 1e-4
    of its largest value, and two calls bit-equal."""
    c, w, x, bias, g, rel = _cuda_case(arch, S, torch.float32, cuda_device)
    kw = dict(num_heads=c["nh"], rel_bias=rel, attn_dropout=0.1, hidden_dropout=0.1, seed=3)
    runs = [fl.fused_bert_layer_bwd(x, bias, w, g, **kw) for _ in range(2)]
    rdx, rdw = fl.fused_bert_layer_bwd_plain(x, bias, w, g, **kw)
    (dx, dw), (dx2, dw2) = runs
    assert torch.equal(dx, dx2) and all(torch.equal(dw[n], dw2[n]) for n in dw)
    assert ("drel" in dw) == (rel is not None)
    for n, r in dict(rdw, dx=rdx).items():
        got = dict(dw, dx=dx)[n]
        scale = (rdw["bq"] if n == "bk" else r).abs().max().item()
        assert (got - r).abs().max().item() <= 1e-4 * scale, n
