"""The port's Marian seq2seq (``qst_tpu_torch/models/seq2seq.py``) against
qst_tpu's (``qst_tpu/models/seq2seq.py``) at ``Seq2SeqConfig.tiny()`` on the
CPU, on JAX ``init_seq2seq`` weights carried over by
``marian_state_dict_from_flax_params``:

- ``Seq2SeqConfig`` and ``sinusoidal_positions`` exactly;
- encode, decode and full-forward logits to 1e-5 (f32), over gelu / swish
  and ``scale_embedding`` on and off; ``decode_token`` step by step against
  the full decode;
- the four decoders' tokens EQUAL to JAX's over ``num_beams`` 1 and 3,
  ``suppress_tokens``, ``forced_eos`` False / True / an int other than EOS,
  ``length_penalty`` 1.0 and 0.6, ``max_length`` 2, and a batch where some
  rows finish early while others run to the forced EOS (there with the early
  exit checked every 2 steps, against JAX's full loop);
- ``_top_k`` in ``lax.top_k``'s order on ties, ``init_seq2seq``'s
  distribution, and the HF parameter names.

The weights are JAX's init with a random final-logits bias; the decoders'
also have wider query/key and FFN kernels and embedding (both packages get
the same arrays), so that rows and steps differ.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qst_tpu.models import seq2seq as js
from qst_tpu_torch.models import seq2seq as ts
from qst_tpu_torch.models.hf_import import marian_state_dict_from_flax_params

ATOL = 1e-5
PAD, EOS = 99, 0



@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the decode loops are many tiny ops, which a thread
    pool only slows, most of all in the suite's parallel run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _cfgs(**over):
    return js.Seq2SeqConfig.tiny(**over), ts.Seq2SeqConfig.tiny(**over)


# JAX's init decodes one token over and over (the tied embedding's
# self-similarity wins); these factors make rows and steps differ
WIDEN = {"q_proj": 3.0, "k_proj": 3.0, "fc1": 2.0, "fc2": 2.0}


def _widen(path, x):
    names = [getattr(k, "key", None) for k in path]
    return x * WIDEN.get(names[-2], 1.0) if names[-1] == "kernel" else x


def _params(jcfg, seed=0, eos_bias=0.0, widen=True):
    """JAX init with the final-logits bias random (EOS's raised by
    ``eos_bias``) and, with ``widen``, the query/key and FFN kernels and the
    embedding widened, as numpy (the JAX tree) and as the port's state
    dict."""
    params = jax.tree.map(np.asarray, js.init_seq2seq(jcfg, jax.random.key(seed)))
    if widen:
        params = jax.tree_util.tree_map_with_path(_widen, params)
        params["shared"]["embedding"] = params["shared"]["embedding"] * 5.0
    bias = np.random.default_rng(seed).normal(0.0, 1.0, jcfg.vocab_size).astype(np.float32)
    bias[jcfg.eos_token_id] += eos_bias
    params["final_logits_bias"] = bias
    cfg = ts.Seq2SeqConfig(**dataclasses.asdict(jcfg))
    return params, marian_state_dict_from_flax_params(params, cfg)


def _inputs(B=4, S=10, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, PAD - 1, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 7:] = 0
    mask[3, 4:] = 0
    ids[mask == 0] = PAD
    return ids, mask


@pytest.fixture(scope="module")
def tiny():
    jcfg, cfg = _cfgs()
    params, sd = _params(jcfg, widen=False)
    return jcfg, cfg, params, sd


def test_config_and_positions_are_the_source():
    for over in ({}, {"scale_embedding": True, "activation": "swish"}):
        jcfg, cfg = _cfgs(**over)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(ts.Seq2SeqConfig()) == dataclasses.asdict(js.Seq2SeqConfig())
    for n, dim in ((64, 32), (17, 7), (130, 96)):
        np.testing.assert_array_equal(ts.sinusoidal_positions(n, dim),
                                      js.sinusoidal_positions(n, dim))


@pytest.mark.parametrize("activation", ["gelu", "swish"])
@pytest.mark.parametrize("scale_embedding", [False, True], ids=["unscaled", "scaled"])
def test_logits_match_jax(activation, scale_embedding):
    jcfg, cfg = _cfgs(activation=activation, scale_embedding=scale_embedding)
    params, sd = _params(jcfg, seed=1, widen=False)
    ids, mask = _inputs()
    dec = np.random.default_rng(2).integers(1, PAD - 1, (4, 6)).astype(np.int32)
    dmask = np.ones_like(dec)
    dmask[2, 4:] = 0
    jm, v = js.MarianModule(jcfg), {"params": params}
    j_enc = jm.apply(v, jnp.asarray(ids), jnp.asarray(mask), method=js.MarianModule.encode)
    j_dec = jm.apply(v, jnp.asarray(dec), jnp.asarray(dmask), j_enc, jnp.asarray(mask),
                     method=js.MarianModule.decode)
    j_all = jm.apply(v, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(dec), jnp.asarray(dmask))
    model = ts.marian_module(cfg, sd)
    t = {k: torch.from_numpy(x).long() for k, x in
         (("ids", ids), ("mask", mask), ("dec", dec), ("dmask", dmask))}
    with torch.no_grad():
        enc = model.encode(t["ids"], t["mask"])
        got_dec = model.decode(t["dec"], t["dmask"], torch.from_numpy(np.array(j_enc)), t["mask"])
        got_all = model(t["ids"], t["mask"], t["dec"], t["dmask"])
    assert got_all.shape == (4, 6, cfg.vocab_size) and got_all.dtype == torch.float32
    np.testing.assert_allclose(enc.numpy(), np.asarray(j_enc), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_dec.numpy(), np.asarray(j_dec), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_all.numpy(), np.asarray(j_all), rtol=0, atol=ATOL)


def test_decode_token_matches_the_full_decode(tiny):
    jcfg, cfg, params, sd = tiny
    ids, mask = _inputs()
    dec = np.random.default_rng(3).integers(1, PAD - 1, (4, 9)).astype(np.int64)
    model = ts.marian_module(cfg, sd)
    mask_t = torch.from_numpy(mask).long()
    with torch.no_grad():
        enc = model.encode(torch.from_numpy(ids).long(), mask_t)
        full = model.decode(torch.from_numpy(dec), torch.ones(4, 9, dtype=torch.long), enc, mask_t)
        caches = model.init_decode_cache(enc, 9)
        assert caches["self_kv"].shape == (cfg.decoder_layers, 2, 4, cfg.num_heads, 9, 8)
        for t in range(9):
            logits, caches = model.decode_token(torch.from_numpy(dec[:, t:t + 1]), t, mask_t,
                                                caches)
            np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(), rtol=0, atol=ATOL)
    # and JAX's decode_token at the last step, from its own caches
    jm = js.MarianModule(jcfg)

    @jax.jit
    def jax_steps(v, ids, mask, dec):
        enc = jm.apply(v, ids, mask, method=js.MarianModule.encode)
        caches = jm.apply(v, enc, 9, method=js.MarianModule.init_decode_cache)
        for t in range(9):
            logits, caches = jm.apply(v, dec[:, t:t + 1], t, mask, caches,
                                      method=js.MarianModule.decode_token)
        return logits

    j_logits = jax_steps({"params": params}, jnp.asarray(ids), jnp.asarray(mask),
                         jnp.asarray(dec, jnp.int32))
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), rtol=0, atol=ATOL)


# (id, num_beams, suppress_tokens, forced_eos, length_penalty, max_length, eos_bias)
CASES = [
    ("one_beam", 1, (PAD,), False, 1.0, 12, 0.0),
    ("forced_int_early_eos", 3, (PAD, 7), 5, 0.6, 10, 12.0),
    ("max_length_2", 3, (), True, 1.0, 2, 0.0),
]
DECODERS = ["greedy_decode", "greedy_decode_cached", "beam_decode", "beam_decode_cached"]


def _decode_both(decoder, case, B=6):
    name, beams, suppress, feos, lp, max_length, eos_bias = case
    jcfg, cfg = _cfgs()
    params, sd = _params(jcfg, seed=4, eos_bias=eos_bias)
    ids, mask = _inputs(B=B, S=9, seed=5)
    kw = dict(max_length=max_length, suppress_tokens=suppress, forced_eos=feos)
    if decoder.startswith("beam"):
        kw.update(num_beams=beams, length_penalty=lp)
    want = np.asarray(getattr(js, decoder)(params, jnp.asarray(ids), jnp.asarray(mask), jcfg,
                                           **kw))
    got = getattr(ts, decoder)(sd, ids, mask, cfg, **kw)
    assert got.shape == (B, max_length) and got.dtype == torch.long
    return got.numpy(), want


@pytest.mark.parametrize("decoder", DECODERS)
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_decoders_equal_jax(case, decoder):
    got, want = _decode_both(decoder, case)
    np.testing.assert_array_equal(got, want)
    assert (want[:, 0] == PAD).all()
    assert len({tuple(row) for row in want}) > 1 or case[5] == 2
    feos = case[3]
    if feos is not False:
        forced = EOS if feos is True else feos
        assert ((want == EOS).any(axis=1) | (want[:, -1] == forced)).all()
    if case[0] == "forced_int_early_eos":
        # some rows end early, the others run to the forced token
        early = (want[:, :-1] == EOS).any(axis=1)
        assert early.any() and (want[~early, -1] == feos).all() and not early.all(), want


@pytest.mark.parametrize("decoder", ["greedy_decode_cached", "beam_decode_cached"])
def test_early_exit_leaves_the_tokens(decoder, monkeypatch):
    """With every row done the loop stops at its next check; the tokens
    equal JAX's full ``max_length - 1`` steps."""
    steps = []
    stop = ts._stop
    monkeypatch.setattr(ts, "EXIT_CHECK_EVERY", 2)
    monkeypatch.setattr(ts, "_stop", lambda t, done: steps.append(t) or stop(t, done))
    got, want = _decode_both(decoder, ("exit", 3, (PAD,), True, 0.6, 16, 20.0))
    np.testing.assert_array_equal(got, want)
    assert len(steps) < 15 and (want[:, -1] == PAD).all(), (steps, want)


def test_top_k_keeps_lax_order_on_ties():
    rng = np.random.default_rng(6)
    x = rng.choice(np.array([-1e9, -3.5, 0.0, -0.0, 2.25, -1e9 + 64], np.float32), (5, 40))
    x[0, :] = -1e9
    for k in (1, 3, 8):
        want_s, want_i = jax.lax.top_k(jnp.asarray(x), k)
        got_s, got_i = ts._top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_init_seq2seq_draws_the_source_distribution():
    cfg = ts.Seq2SeqConfig.tiny(d_model=64, ffn_dim=256, vocab_size=4000)
    sd = ts.init_seq2seq(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert set(sd) == set(ts.MarianModule(cfg).state_dict())
    np.testing.assert_array_equal(sd["model.encoder.embed_positions.weight"].numpy(),
                                  ts.sinusoidal_positions(cfg.max_position_embeddings, 64))
    assert torch.equal(sd["model.encoder.embed_positions.weight"],
                       sd["model.decoder.embed_positions.weight"])
    assert not sd["final_logits_bias"].any() and not sd["model.encoder.layers.0.fc1.bias"].any()
    assert (sd["model.decoder.layers.1.encoder_attn_layer_norm.weight"] == 1).all()
    emb = sd["model.shared.weight"]
    assert abs(float(emb.std()) - 64 ** -0.5) < 0.02 * 64 ** -0.5
    fc2 = sd["model.encoder.layers.0.fc2.weight"]        # (64, 256): fan_in 256
    assert abs(float(fc2.std()) - 256 ** -0.5) < 0.05 * 256 ** -0.5
    assert float(fc2.abs().max()) <= 2 * 256 ** -0.5 / 0.87962566103423978 + 1e-6
    again = ts.init_seq2seq(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(sd[k], again[k]) for k in sd)


class _IdTok:
    """tests/test_seq2seq.py's tokenizer over small ids (batch_encode / decode)."""

    def batch_encode(self, texts, max_length=16):
        ids = np.full((len(texts), max_length), PAD, np.int32)
        mask = np.zeros((len(texts), max_length), np.int32)
        for i, t in enumerate(texts):
            toks = [min(ord(c) % 90 + 1, PAD - 1) for c in t[:max_length - 1]] + [EOS]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return ids, mask

    def decode(self, token_ids):
        return " ".join(str(t) for t in token_ids)


def test_greedy_backtranslator_matches_jax():
    jcfg, cfg = _cfgs()
    (jp1, sd1), (jp2, sd2) = _params(jcfg, seed=8), _params(jcfg, seed=9)
    texts = ["hello world", "a cat", "the quick brown fox"]
    ours = ts.JaxBacktranslator((cfg, sd1), (cfg, sd2), _IdTok(), _IdTok(), max_length=12)
    theirs = js.JaxBacktranslator((jcfg, jp1), (jcfg, jp2), _IdTok(), _IdTok(), max_length=12)
    got = ours.backtranslate(texts)
    assert got == theirs.backtranslate(texts) and len(set(got)) > 1, got
