"""The port's flash-attention path against qst_tpu's (``use_flash_attention``).

JAX's side is the library kernel qst_tpu calls
(``jax.experimental.pallas.ops.tpu.flash_attention``), run on the CPU inside
``force_tpu_interpret_mode()`` by ``tests/flash_library_side.py`` in a
process of its own, once for the module (the ``library`` fixture: the
interpreter's process-wide state stalled a kernel in a worker that had run
other JAX tests); the port's side is ``ops/flash_attention.py``,
whose wrappers take their plain versions for CPU tensors. Inputs are numpy
arrays made from seeds and fed to both. Tolerances: 1e-5 absolute at f32 for
outputs (the sums run in another order), 1e-5 of each tensor's largest value
for gradients. The ``cuda`` cases hold K7/K8 to the plain versions on a card
and skip elsewhere.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu import flash_attention as jfa

from qst_tpu.core.config import EncoderConfig as JaxConfig
from qst_tpu.models import bert as jbert
from qst_tpu.models import sentence_encoder as jse
from qst_tpu_torch.core.config import EncoderConfig
from qst_tpu_torch.models import bert as tbert
from qst_tpu_torch.models import sentence_encoder as tse
from qst_tpu_torch.models.hf_import import state_dict_from_flax_params
from qst_tpu_torch.ops import flash_attention as tfa
from qst_tpu_torch.ops import fused_layer as fl
from qst_tpu_torch.train import train_step as tts

ATOL = 1e-5
OP_CASES = [(128, 16), (128, 32), (256, 16), (256, 32)]


def _op_inputs(B, nh, S, hd, seed):
    """q, k, v, dO (B, nh, S, hd) f32 and segment ids: sequence 0 padded at
    its end, sequence 1 all padding (every id 0)."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((B, nh, S, hd)).astype(np.float32) for _ in range(4))
    seg = np.ones((B, S), np.int32)
    seg[0, S - 37:] = 0
    seg[1, :] = 0
    return q, k, v, do, seg


NO_MATCH = (256, 32)   # S, hd of the case with query rows that match no key


def _no_match_q(seg):
    """seg_q for the keys' ``seg`` of ``_op_inputs`` in which query rows
    match no key: sequence 0's row 5 and sequence 1's first three rows (its
    keys are all padding) get segments no key has."""
    seg_q = seg.copy()
    seg_q[0, 5] = 7
    seg_q[1, :3] = 3
    return seg_q


def _port_fwd_bwd(q, k, v, do, seg, dtype=torch.float32, device="cpu", seg_q=None):
    t = [torch.from_numpy(x).to(device, dtype).requires_grad_() for x in (q, k, v)]
    s = torch.from_numpy(seg).to(device)
    sq = s if seg_q is None else torch.from_numpy(seg_q).to(device)
    o = tfa.FlashAttention.apply(*t, sq, s, q.shape[-1] ** -0.5)
    (o.float() * torch.from_numpy(do).to(device)).sum().backward()
    return o.detach().float().cpu().numpy(), [x.grad.float().cpu().numpy() for x in t]


@pytest.mark.parametrize("S,hd", OP_CASES)
def test_plain_versions_are_the_library_kernel(library, S, hd):
    """flash_attention_plain and flash_attention_bwd_plain (through
    ``FlashAttention``) against the library's flash_attention and its
    jax.grad in interpret mode, and against mha_reference (forward) and the
    autodiff of mha_reference_no_custom_vjp (gradients), with padded and
    all-padding rows; the plain forward's (m, l) against the library's
    residuals."""
    q, k, v, do, seg = _op_inputs(2, 2, S, hd, seed=S + hd)
    sc = hd ** -0.5
    ids = jfa.SegmentIds(jnp.asarray(seg), jnp.asarray(seg))

    def ref(q, k, v):
        return jfa.mha_reference_no_custom_vjp(q, k, v, segment_ids=ids, sm_scale=sc)

    case = f"op{S}_{hd}"
    want_g = [library[f"{case}_d{n}"] for n in "qkv"]
    ref_o = np.asarray(jfa.mha_reference(q, k, v, None, ids, sm_scale=sc))
    ref_g = jax.grad(lambda *a: jnp.sum(ref(*a) * do), argnums=(0, 1, 2))(q, k, v)
    got_o, got_g = _port_fwd_bwd(q, k, v, do, seg)
    for want in (library[f"{case}_o"], ref_o):
        np.testing.assert_allclose(got_o, want, rtol=0, atol=ATOL)
    for gw, gr, g in zip(want_g, ref_g, got_g):
        for w in (gw, np.asarray(gr)):
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL * np.abs(w).max())
    _, m, l = tfa.flash_attention_plain(*(torch.from_numpy(x) for x in (q, k, v)),
                                        torch.from_numpy(seg), torch.from_numpy(seg), sc,
                                        return_stats=True)
    np.testing.assert_allclose(m.numpy(), library[f"{case}_m"], rtol=1e-6, atol=ATOL)
    np.testing.assert_allclose(l.numpy(), library[f"{case}_l"], rtol=1e-5, atol=0)


def test_plain_versions_are_the_library_kernel_for_rows_that_match_no_key(library):
    """seg_q != seg_kv with query rows whose segment no key has: the
    library's forward gives such a row the plain average of v over every key
    (each logit is the mask value), and its backward the matching
    gradients; the plain versions through ``FlashAttention`` against both,
    and (m, l) against the library's residuals. The CUDA kernels are held to
    these plain versions on the card (a skipped masked tile would break
    exactly these rows)."""
    q, k, v, do, seg = _op_inputs(2, 2, *NO_MATCH, seed=5)
    seg_q = _no_match_q(seg)
    got_o, got_g = _port_fwd_bwd(q, k, v, do, seg, seg_q=seg_q)
    np.testing.assert_allclose(got_o, library["nomatch_o"], rtol=0, atol=ATOL)
    for n, g in zip("qkv", got_g):
        w = library[f"nomatch_d{n}"]
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL * np.abs(w).max())
    for b, r in ((0, [5]), (1, [0, 1, 2])):
        np.testing.assert_allclose(got_o[b][:, r], np.broadcast_to(
            v[b].mean(axis=1, keepdims=True), got_o[b][:, r].shape), rtol=0, atol=ATOL)
    sc = NO_MATCH[1] ** -0.5
    _, m, l = tfa.flash_attention_plain(*(torch.from_numpy(x) for x in (q, k, v)),
                                        torch.from_numpy(seg_q), torch.from_numpy(seg), sc,
                                        return_stats=True)
    np.testing.assert_allclose(m.numpy(), library["nomatch_m"], rtol=1e-6, atol=ATOL)
    np.testing.assert_allclose(l.numpy(), library["nomatch_l"], rtol=1e-5, atol=0)


@pytest.mark.parametrize("flag", [False, True])
@pytest.mark.parametrize("attention_dropout", [0.0, 0.1])
def test_gate_is_the_source(flag, attention_dropout):
    """_flash_attention_available is qst_tpu/models/bert.py:59-70 on a grid
    of S, deterministic and dropout."""
    kw = dict(use_flash_attention=flag, attention_dropout=attention_dropout)
    jcfg, cfg = JaxConfig.tiny(**kw), EncoderConfig.tiny(**kw)
    for S in (64, 100, 127, 128, 130, 192, 256, 384, 512, 2048):
        for det in (False, True):
            assert (tbert._flash_attention_available(cfg, S, det)
                    == jbert._flash_attention_available(jcfg, S, det)), (S, det)


def _flash_cfg(**over):
    base = dict(use_flash_attention=True, max_seq_length=128, max_position_embeddings=128)
    base.update(over)
    return JaxConfig.tiny(**base), EncoderConfig.tiny(**base)


def _enc_inputs(cfg, B=3, S=128, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, cfg.vocab_size, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    for i, n in enumerate((S, 77, 5)[:B]):
        mask[i, n:] = 0
    return ids, mask


def _jax_weights(jcfg, seed=11):
    """qst_tpu's init_params with the flag off (the same tree: the flag
    changes no parameter, tests/test_flash_attention.py:45; init's forward
    at max_seq_length would need the kernel outside interpret mode)."""
    off = dataclasses.replace(jcfg, use_flash_attention=False)
    return jax.tree.map(np.asarray, jse.init_params(off, jax.random.key(seed)))


def _port_model(cfg, params):
    model = tse.SentenceEncoderModule(cfg)
    model.load_state_dict(state_dict_from_flax_params(params, cfg))
    return model.eval()


def _encoder_loss_weights(cfg, B):
    return np.random.default_rng(3).standard_normal((B, cfg.hidden_size)).astype(np.float32)


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    """The library kernel's results in interpret mode, from one subprocess
    (``tests/flash_library_side.py``): each op case of OP_CASES, the case
    with query rows that match no key (``nomatch``), and JAX's
    tiny flash encoder at S = 128 (its outputs and the gradient of
    Σ w·sentence_embedding w.r.t. every parameter, as the port's names)."""
    d = tmp_path_factory.mktemp("flash_library")
    inp = {"cases": np.array([f"op{S}_{hd}" for S, hd in OP_CASES] + ["nomatch"])}
    for S, hd in OP_CASES:
        for n, x in zip(("q", "k", "v", "do", "seg"), _op_inputs(2, 2, S, hd, seed=S + hd)):
            inp[f"op{S}_{hd}_{n}"] = x
    q, k, v, do, seg = _op_inputs(2, 2, *NO_MATCH, seed=5)
    inp.update(nomatch_q=q, nomatch_k=k, nomatch_v=v, nomatch_do=do, nomatch_seg=_no_match_q(seg),
               nomatch_segkv=seg)
    jcfg, cfg = _flash_cfg()
    ids, mask = _enc_inputs(cfg)
    inp.update(enc_cfg=np.array(json.dumps(dataclasses.asdict(jcfg))), enc_seed=np.array(11),
               enc_ids=ids, enc_mask=mask, enc_w=_encoder_loss_weights(cfg, ids.shape[0]))
    np.savez(d / "in.npz", **inp)
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "flash_library_side.py")
    run = subprocess.run([sys.executable, script, str(d / "in.npz"), str(d / "out.npz")],
                         capture_output=True, text=True, timeout=900)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    with np.load(d / "out.npz") as f:
        return dict(f)


@pytest.fixture(scope="module")
def flash_encoder(library):
    """JAX's tiny flash encoder at S = 128 in interpret mode (the
    ``library`` fixture), with the weights and inputs it ran on."""
    jcfg, cfg = _flash_cfg()
    ids, mask = _enc_inputs(cfg)
    grads = {k[len("grad/"):]: torch.from_numpy(v) for k, v in library.items()
             if k.startswith("grad/")}
    return dict(jcfg=jcfg, cfg=cfg, params=_jax_weights(jcfg), ids=ids, mask=mask,
                w=_encoder_loss_weights(cfg, ids.shape[0]),
                out={k: library[k] for k in ("token_embeddings", "sentence_embedding")},
                grads=grads)


def test_flash_encoder_matches_jax(flash_encoder, monkeypatch):
    """token_embeddings (pad rows included) and sentence_embedding of the
    port's tiny flash encoder against JAX's, and the route: one plain K7
    call a layer."""
    f = flash_encoder
    calls = []
    plain = tfa.flash_attention_plain
    monkeypatch.setattr(tfa, "flash_attention_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    with torch.no_grad():
        out = _port_model(f["cfg"], f["params"])(torch.from_numpy(f["ids"]),
                                                  torch.from_numpy(f["mask"]))
    assert len(calls) == f["cfg"].num_layers
    for name in ("token_embeddings", "sentence_embedding"):
        np.testing.assert_allclose(out[name].numpy(), f["out"][name], rtol=0, atol=ATOL)


def test_flash_encoder_gradient_matches_jax(flash_encoder, monkeypatch):
    """jax.grad of the flash encoder against the port's backward (K8's plain
    version, one call a layer), to 1e-5 of each tensor's largest value. The
    key bias's gradient is zero up to rounding (softmax ignores a constant
    added to a row of logits), so it is noise in both packages and is held
    to the scale of the query bias's gradient of its layer, as chip_smoke's
    grad_errors holds K2's."""
    f = flash_encoder
    calls = []
    plain = tfa.flash_attention_bwd_plain
    monkeypatch.setattr(tfa, "flash_attention_bwd_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    model = _port_model(f["cfg"], f["params"])
    out = model(torch.from_numpy(f["ids"]), torch.from_numpy(f["mask"]))
    (out["sentence_embedding"] * torch.from_numpy(f["w"])).sum().backward()
    assert len(calls) == f["cfg"].num_layers
    got = dict(model.named_parameters())
    for name, want in f["grads"].items():
        want = want.numpy()
        like = name.replace(".key.bias", ".query.bias")
        scale = np.abs(f["grads"][like].numpy()).max()
        np.testing.assert_allclose(got[name].grad.numpy(), want, rtol=0, atol=ATOL * scale,
                                   err_msg=name)


def test_flash_pad_rows_differ_from_the_einsum_path_while_pooled_agree(flash_encoder):
    """The finding that makes the flash path a function of its own: with
    segment ids a padded query row attends to the padded keys only, while
    the einsum path's bias lets it attend to the real keys. Real rows and
    the pooled embeddings agree; pad rows do not."""
    f = flash_encoder
    off = dataclasses.replace(f["cfg"], use_flash_attention=False)
    with torch.no_grad():
        ein = _port_model(off, f["params"])(torch.from_numpy(f["ids"]),
                                            torch.from_numpy(f["mask"]))
    tok, pooled = f["out"]["token_embeddings"], f["out"]["sentence_embedding"]
    real = f["mask"].astype(bool)
    np.testing.assert_allclose(ein["sentence_embedding"].numpy(), pooled, rtol=0, atol=ATOL)
    np.testing.assert_allclose(ein["token_embeddings"].numpy()[real], tok[real], rtol=0,
                               atol=ATOL)
    assert np.abs(ein["token_embeddings"].numpy()[~real] - tok[~real]).max() > 0.05


def test_attention_dropout_in_training_takes_the_einsum_path(monkeypatch):
    """As JAX's gate decides: in train() mode with a generator and attention
    dropout > 0 the flash path is not taken; at attention dropout 0 it is,
    forward and backward, with the hidden dropout at its rate."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = tfa.flash_attention_plain, tfa.flash_attention_bwd_plain

    def count(name, fn):
        return lambda *a, **kw: calls.__setitem__(name, calls[name] + 1) or fn(*a, **kw)

    monkeypatch.setattr(tfa, "flash_attention_plain", count("fwd", fwd))
    monkeypatch.setattr(tfa, "flash_attention_bwd_plain", count("bwd", bwd))
    for rate, want in ((0.1, 0), (0.0, 2)):
        _, cfg = _flash_cfg(attention_dropout=rate, hidden_dropout=0.1)
        model = tse.SentenceEncoderModule(cfg).train()
        ids, mask = _enc_inputs(cfg, B=2, seed=5)
        calls.update(fwd=0, bwd=0)
        out = model(torch.from_numpy(ids), torch.from_numpy(mask),
                    dropout_generator=torch.Generator().manual_seed(1))
        out["sentence_embedding"].sum().backward()
        assert calls == {"fwd": want, "bwd": want}, (rate, calls)


def test_remat_flash_gives_the_same_values_and_gradients():
    jcfg, cfg = _flash_cfg(attention_dropout=0.0)
    params = _jax_weights(jcfg, seed=2)
    ids, mask = _enc_inputs(cfg, B=2, seed=6)
    res = []
    for remat in (False, True):
        model = _port_model(dataclasses.replace(cfg, remat=remat), params).train()
        out = model(torch.from_numpy(ids), torch.from_numpy(mask),
                    dropout_generator=torch.Generator().manual_seed(4))
        out["sentence_embedding"].square().sum().backward()
        res.append((out["sentence_embedding"].detach(),
                    [p.grad.clone() for p in model.parameters()]))
    torch.testing.assert_close(res[0][0], res[1][0], rtol=0, atol=0)
    for a, b in zip(res[0][1], res[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_mpnet_with_the_flag_runs_its_own_path():
    """Repair 1: qst_tpu's MPNetEncoder never reads use_flash_attention, so
    the tiny MPNet with the flag is JAX's with the flag (the port raised)."""
    base = dict(arch="mpnet", pad_token_id=1, use_flash_attention=True,
                max_seq_length=128, max_position_embeddings=130)
    jcfg, cfg = JaxConfig.tiny(**base), EncoderConfig.tiny(**base)
    params = jax.tree.map(np.asarray, jse.init_params(jcfg, jax.random.key(8)))
    ids, mask = _enc_inputs(cfg, B=2, seed=9)
    ids[~mask.astype(bool)] = cfg.pad_token_id
    want = jse.SentenceEncoderModule(jcfg).apply({"params": params}, jnp.asarray(ids),
                                                 jnp.asarray(mask))
    with torch.no_grad():
        got = _port_model(cfg, params)(torch.from_numpy(ids), torch.from_numpy(mask))
    for name in ("token_embeddings", "sentence_embedding"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=0, atol=ATOL)


def test_fused_layer_wins_over_flash(monkeypatch):
    """Repair 2: with use_fused_layer the flag no longer raises, and encode
    and the train step take the fused layer (K1/K2's plain versions here) as
    qst_tpu does (sentence_encoder.py:76, train_step.py:58); nothing of
    K7/K8 runs. The embedding is JAX's fused embed_fn's."""
    jcfg, cfg = _flash_cfg(use_fused_layer=True, attention_dropout=0.0, hidden_dropout=0.0)
    params = _jax_weights(jcfg, seed=12)
    ids, mask = _enc_inputs(cfg, B=2, seed=7)

    def banned(*a, **kw):
        raise AssertionError("a flash-attention plain version ran on the fused path")

    monkeypatch.setattr(tfa, "flash_attention_plain", banned)
    monkeypatch.setattr(tfa, "flash_attention_bwd_plain", banned)
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = fl.fused_bert_layer_plain, fl.fused_bert_layer_bwd_plain
    monkeypatch.setattr(fl, "fused_bert_layer_plain", lambda *a, **kw: calls.__setitem__(
        "fwd", calls["fwd"] + 1) or fwd(*a, **kw))
    monkeypatch.setattr(fl, "fused_bert_layer_bwd_plain", lambda *a, **kw: calls.__setitem__(
        "bwd", calls["bwd"] + 1) or bwd(*a, **kw))
    got = tse.embed_fn(cfg)(_port_model(cfg, params), torch.from_numpy(ids),
                            torch.from_numpy(mask))
    assert calls["fwd"] == cfg.num_layers
    want = np.asarray(jse.embed_fn(jcfg)(params, jnp.asarray(ids), jnp.asarray(mask)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    from qst_tpu_torch.core.config import LossConfig, TrainConfig

    state, _ = tts.create_train_state(cfg, TrainConfig(batch_size=2),
                                      torch.Generator().manual_seed(0), total_steps=2,
                                      device="cpu")
    four = np.stack([ids] * 4), np.stack([mask] * 4)
    calls.update(fwd=0, bwd=0)
    _, loss = tts.make_train_step(cfg, LossConfig())(state, *four)
    assert np.isfinite(float(loss))
    assert calls == {"fwd": cfg.num_layers, "bwd": cfg.num_layers}


def test_train_step_runs_k7_and_k8_on_the_module_path(monkeypatch):
    """make_train_step with the flag at attention dropout 0: forward and
    backward through FlashAttention (plain versions here), one call of each
    a layer, with the hidden dropout drawn from the step's key; then, on a
    repeated batch without dropout, a loss that falls."""
    from qst_tpu_torch.core.config import LossConfig, TrainConfig

    _, cfg = _flash_cfg(attention_dropout=0.0)
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = tfa.flash_attention_plain, tfa.flash_attention_bwd_plain
    monkeypatch.setattr(tfa, "flash_attention_plain", lambda *a, **kw: calls.__setitem__(
        "fwd", calls["fwd"] + 1) or fwd(*a, **kw))
    monkeypatch.setattr(tfa, "flash_attention_bwd_plain", lambda *a, **kw: calls.__setitem__(
        "bwd", calls["bwd"] + 1) or bwd(*a, **kw))
    state, _ = tts.create_train_state(
        cfg, TrainConfig(batch_size=2, learning_rate=1e-3, warmup_steps=0),
        torch.Generator().manual_seed(0), total_steps=8, device="cpu")
    ids, mask = _enc_inputs(cfg, B=8, seed=1)
    four = ids.reshape(4, 2, -1), mask.reshape(4, 2, -1)
    step = tts.make_train_step(cfg, LossConfig())
    losses = []
    for i in range(4):
        state, loss = step(state, *four, tts.dropout_key(0, i) if i == 0 else None)
        losses.append(float(loss))
    assert calls == {"fwd": 4 * cfg.num_layers, "bwd": 4 * cfg.num_layers}
    assert np.isfinite(losses).all() and losses[-1] < losses[1]


def test_flash_wrapper_refuses_what_the_kernels_do_not_take():
    q = torch.zeros(1, 1, 130, 16)
    seg = torch.zeros(1, 130, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 128"):
        tfa.flash_attention(q, q, q, seg, seg, 0.25)
    with pytest.raises(ValueError, match="seg_q"):
        tfa.flash_attention(q[:, :, :128], q[:, :, :128], q[:, :, :128], seg, seg, 0.25)


# ---------------------------------------------------------------------------
# The kernels on a card (skip without one)
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K7/K8 are CUDA kernels with no CPU mode")
    return torch.device("cuda")


def _bf16_close_to_plain(q, k, v, do, seg_q, seg_kv, sc):
    """bf16 K7 and K8 against their plain versions on the same inputs: o
    within 2e-2 of max|o|, gradients within 2e-2 of their largest value at
    most and 2^-7 of their mean, K8 bit-equal between two calls."""
    o, m, l = tfa.flash_attention(q, k, v, seg_q, seg_kv, sc, return_stats=True)
    o_ref = tfa.flash_attention_plain(q, k, v, seg_q, seg_kv, sc)
    d = (o.float() - o_ref.float()).abs()
    assert d.max().item() <= 2e-2 * o_ref.float().abs().max().item()
    g1 = tfa.flash_attention_bwd(q, k, v, seg_q, seg_kv, o, m, l, do, sc)
    g2 = tfa.flash_attention_bwd(q, k, v, seg_q, seg_kv, o, m, l, do, sc)
    ref = tfa.flash_attention_bwd_plain(q, k, v, seg_q, seg_kv, o, m, l, do, sc)
    for a, b, r in zip(g1, g2, ref):
        assert torch.equal(a, b)
        d = (a.float() - r.float()).abs()
        assert d.max().item() <= 2e-2 * r.float().abs().max().item()
        assert d.mean().item() <= 2.0 ** -7 * r.float().abs().mean().item()


@pytest.mark.cuda
@pytest.mark.parametrize("S,hd", [(128, 16), (256, 32), (512, 64), (2048, 32)])
def test_k7_k8_f32_against_the_plain_versions_on_the_card(cuda, S, hd):
    """f32 (SIMT) K7 and K8 against their plain versions: 1e-4 absolute for
    o, 1e-4 of each gradient's largest value."""
    q, k, v, do, seg = _op_inputs(2, 3, S, hd, seed=S)
    got_o, got_g = _port_fwd_bwd(q, k, v, do, seg, device=cuda)
    want_o, want_g = _port_fwd_bwd(q, k, v, do, seg)
    np.testing.assert_allclose(got_o, want_o, rtol=0, atol=1e-4)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max())


@pytest.mark.cuda
@pytest.mark.parametrize("S,hd", [(128, 16), (256, 32), (512, 64), (2048, 32)])
def test_k7_k8_bf16_against_the_plain_versions_on_the_card(cuda, S, hd):
    """bf16 K7 and K8 against their plain versions on the same bf16 inputs:
    o within 2e-2 of max|o|, gradients within 2e-2 of their largest value
    at most and 2^-7 of their mean, and K8 bit-equal between two calls."""
    q, k, v, do, seg = _op_inputs(2, 3, S, hd, seed=S + 1)
    bf = [torch.from_numpy(x).to(cuda, torch.bfloat16) for x in (q, k, v, do)]
    s = torch.from_numpy(seg).to(cuda)
    _bf16_close_to_plain(*bf, s, s, hd ** -0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 32, 64])
def test_k7_k8_bf16_rows_that_match_no_key_on_the_card(cuda, hd):
    """seg_q != seg_kv with query rows that match no key (the library's
    uniform average, which a skipped masked tile would break), bf16, held to
    the plain versions."""
    q, k, v, do, seg = _op_inputs(2, 3, NO_MATCH[0], hd, seed=hd)
    bf = [torch.from_numpy(x).to(cuda, torch.bfloat16) for x in (q, k, v, do)]
    seg_q = torch.from_numpy(_no_match_q(seg)).to(cuda)
    _bf16_close_to_plain(*bf, seg_q, torch.from_numpy(seg).to(cuda), hd ** -0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("S,hd", [(384, 16), (512, 32), (640, 64)])
def test_k7_k8_bf16_on_strided_activations_on_the_card(cuda, S, hd):
    """bf16 K7 and K8 on the encoder's (B, S, nh, hd) activations seen as
    (B, nh, S, hd) (the tensor maps' axes in stride order), at a query-tile
    count that is odd (S = 384, 640) and where dQ's sums leave shared
    memory for the scratch (hd 64 at S = 640)."""
    rng = np.random.default_rng(S + hd)
    B, nh = 3, 4
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, S, nh, hd)).astype(np.float32))
                   .to(cuda, torch.bfloat16).transpose(1, 2) for _ in range(4))
    seg = np.ones((B, S), np.int32)
    seg[0, S - 100:] = 0
    seg[1, :] = 0
    s = torch.from_numpy(seg).to(cuda)
    _bf16_close_to_plain(q, k, v, do, s, s, hd ** -0.5)
