"""The port's MarianMT directories and on-card backtranslator against
qst_tpu's, on the CPU at ``Seq2SeqConfig.tiny()``:

- ``load_marian_dir`` on directories ``transformers.MarianMTModel``'s
  ``save_pretrained`` writes (``pytorch_model.bin`` and safetensors): the
  config, the generation defaults and the parameters equal the JAX loader's
  (the names HF's, the multi-token bad-words warning and the non-Marian
  refusal as in the source);
- ``save_marian_dir``: what it writes reads back bit for bit, and loads in
  ``transformers`` (equal logits) and in the JAX loader;
- ``JaxMarianBacktranslator`` with the word-level ``WordTok`` of
  ``tests/test_marian_backend.py`` against JAX's: equal strings for the
  roundtrip, equal tokens for a hop, bucketing changing nothing, TF32 off
  inside a call and the previous setting back after it;
- ``get_backtranslator``'s choice of it (automatic and forced, not masked by
  the memoized singleton) and ``device=None`` raising without CUDA.

The directories the backtranslators read are written by ``save_marian_dir``
from JAX's init with widened kernels (``tests/test_torch_seq2seq.py``), so
that the generated texts differ from row to row.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from transformers import MarianMTModel

from qst_tpu.augment import backtranslation as jbt
from qst_tpu.models import seq2seq as js
from qst_tpu.models.hf_import import load_marian_dir as jax_load_marian_dir
from qst_tpu_torch.augment import backtranslation as tbt
from qst_tpu_torch.models import seq2seq as ts
from qst_tpu_torch.models.hf_export import save_marian_dir
from qst_tpu_torch.models.hf_import import load_marian_dir, marian_state_dict_from_flax_params
from test_marian_backend import EOS, PAD, WordTok, _save_marian
from test_torch_seq2seq import _params

GENERATION = {"num_beams": 3, "max_length": 16, "bad_words_ids": [[PAD]],
              "forced_eos_token_id": EOS}
TEXTS = ["tok11 tok5 tok9", "tok40 tok41 tok42 tok43 tok44", "tok7",
         "tok3 tok30 tok60 tok90 tok12 tok13 tok14 tok15 tok16 tok17 tok18 tok19 tok20",
         "tok88 tok2"]



@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the decode loops are many tiny ops, which a thread
    pool only slows, most of all in the suite's parallel run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(autouse=True)
def fresh_backtranslators(monkeypatch):
    for var in ("QST_MARIAN_EN_FR", "QST_MARIAN_FR_EN", "QST_BACKTRANSLATION_BACKEND"):
        monkeypatch.delenv(var, raising=False)
    jbt.reset_backtranslator()
    tbt.reset_backtranslator()
    yield
    jbt.reset_backtranslator()
    tbt.reset_backtranslator()


@pytest.fixture(scope="module")
def marian_dirs(tmp_path_factory):
    """en→fr and fr→en directories from two seeds, written by the port."""
    root = tmp_path_factory.mktemp("port_marian")
    cfg = ts.Seq2SeqConfig.tiny()
    dirs = []
    for name, seed in (("opus-mt-en-fr", 3), ("opus-mt-fr-en", 7)):
        _, sd = _params(js.Seq2SeqConfig.tiny(), seed=seed)
        dirs.append(save_marian_dir(sd, cfg, str(root / name), generation=GENERATION))
    return dirs


def _same_loads(d):
    """The port's and the JAX loader's reading of one directory agree."""
    jcfg, jparams, jgen = jax_load_marian_dir(d)
    cfg, sd, gen = load_marian_dir(d)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert gen == jgen
    want = marian_state_dict_from_flax_params(jparams, cfg)
    assert set(sd) == set(want) == set(ts.MarianModule(cfg).state_dict())
    for k in want:
        assert sd[k].dtype == torch.float32
        np.testing.assert_array_equal(sd[k].numpy(), want[k].numpy(), err_msg=k)
    return cfg, sd, gen


@pytest.mark.parametrize("safe", [False, True], ids=["bin", "safetensors"])
def test_transformers_directories_load_as_the_jax_loader_reads_them(tmp_path, safe):
    d = _save_marian(tmp_path, "opus-mt-en-fr", seed=3)
    if safe:
        model = MarianMTModel.from_pretrained(d)
        os.remove(os.path.join(d, "pytorch_model.bin"))
        model.save_pretrained(d, safe_serialization=True)
    cfg, sd, gen = _same_loads(d)
    assert (gen["num_beams"], gen["suppress_tokens"], gen["forced_eos"]) == (3, (PAD,), EOS)
    hf = MarianMTModel.from_pretrained(d).eval()
    hf_sd = hf.state_dict()
    for k, v in sd.items():     # HF's own names and arrays (its sinusoids are its own sums)
        tol = 1e-5 if "embed_positions" in k else 0
        np.testing.assert_allclose(v.numpy(), hf_sd[k].numpy().reshape(v.shape), rtol=0,
                                   atol=tol, err_msg=k)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(1, PAD, (2, 7)))
    dec = torch.from_numpy(rng.integers(1, PAD, (2, 5)))
    with torch.no_grad():
        want = hf(input_ids=ids, decoder_input_ids=dec).logits
        got = ts.marian_module(cfg, sd)(ids, torch.ones_like(ids), dec, torch.ones_like(dec))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


def test_load_marian_dir_warns_on_multitoken_bad_words(tmp_path):
    d = _save_marian(tmp_path, "opus-mt-badwords", seed=13, bad_words_ids=[[PAD], [5, 7]])
    with pytest.warns(UserWarning, match="multi-token bad_words_ids"):
        _, _, gen = load_marian_dir(d)
    assert gen["suppress_tokens"] == (PAD,)


def test_load_marian_dir_rejects_non_marian(tmp_path):
    d = tmp_path / "not_marian"
    d.mkdir()
    (d / "config.json").write_text(json.dumps({"model_type": "bert"}))
    (d / "pytorch_model.bin").write_bytes(b"")
    with pytest.raises(ValueError, match="not a MarianMT"):
        load_marian_dir(str(d))


def test_forced_eos_id_other_than_eos_is_read(tmp_path):
    d = _save_marian(tmp_path, "opus-mt-feos", seed=11, forced_eos_token_id=5)
    assert load_marian_dir(d)[2]["forced_eos"] == 5 == jax_load_marian_dir(d)[2]["forced_eos"]


def test_port_written_directories_read_back_everywhere(marian_dirs):
    d = marian_dirs[0]
    assert sorted(os.listdir(d)) == ["config.json", "generation_config.json", "model.safetensors"]
    _, written = _params(js.Seq2SeqConfig.tiny(), seed=3)
    cfg, sd, gen = _same_loads(d)
    for k, v in written.items():
        assert torch.equal(sd[k], v), k
    assert gen["num_beams"] == 3 and gen["max_length"] == 16
    hf = MarianMTModel.from_pretrained(d).eval()
    ids = torch.tensor([[5, 6, 7, EOS], [8, EOS, PAD, PAD]])
    mask = (ids != PAD).long()
    dec = torch.tensor([[PAD, 3, 4], [PAD, 9, 10]])
    with torch.no_grad():
        want = hf(input_ids=ids, attention_mask=mask, decoder_input_ids=dec).logits
        got = ts.marian_module(cfg, sd)(ids, mask, dec, torch.ones_like(dec))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-4 * float(want.abs().max()))


def test_backtranslator_matches_jax(marian_dirs):
    tok = WordTok()
    ours = tbt.JaxMarianBacktranslator(*marian_dirs, max_length=16, tokenizers=(tok, tok),
                                       device="cpu")
    theirs = jbt.JaxMarianBacktranslator(*marian_dirs, max_length=16, tokenizers=(tok, tok))
    assert ours.device == torch.device("cpu") and ours.fwd_gen == theirs.fwd_gen
    enc = tok(tbt.format_batch_texts(TEXTS), max_length=16)
    kw = dict(max_length=16, num_beams=3, suppress_tokens=(PAD,), forced_eos=EOS)
    hop = ts.beam_decode_cached(ours.fwd_params, enc["input_ids"], enc["attention_mask"],
                                ours.fwd_cfg, **kw)
    want = js.beam_decode_cached(theirs.fwd_params, jnp.asarray(enc["input_ids"]),
                                 jnp.asarray(enc["attention_mask"]), theirs.fwd_cfg, **kw)
    np.testing.assert_array_equal(hop.numpy(), np.asarray(want))
    got = ours.backtranslate(TEXTS)
    assert got == theirs.backtranslate(TEXTS)
    assert len(set(got)) > 2 and all(isinstance(t, str) for t in got), got


def test_bucketing_and_precision(marian_dirs, monkeypatch):
    """Masked pad columns added by the bucketing change no token; the
    products run at "highest" inside a call and the setting comes back."""
    cfg, sd, _ = load_marian_dir(marian_dirs[0])
    enc = WordTok()(["tok8 tok9", "tok10 tok11 tok12"], max_length=32)
    ids, mask = enc["input_ids"], enc["attention_mask"]
    pad_w = ((0, 0), (0, 16 - ids.shape[1]))
    a = ts.beam_decode_cached(sd, ids, mask, cfg, max_length=12, num_beams=3)
    b = ts.beam_decode_cached(sd, np.pad(ids, pad_w, constant_values=PAD),
                              np.pad(mask, pad_w, constant_values=0), cfg, max_length=12,
                              num_beams=3)
    assert torch.equal(a, b)

    seen, decode = [], ts.beam_decode_cached
    monkeypatch.setattr(ts, "beam_decode_cached",
                        lambda *a, **kw: seen.append(torch.get_float32_matmul_precision())
                        or decode(*a, **kw))
    tok = WordTok()
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        for precision, inside in (("highest", "highest"), ("default", "high")):
            bt = tbt.JaxMarianBacktranslator(*marian_dirs, max_length=16, tokenizers=(tok, tok),
                                             matmul_precision=precision, device="cpu")
            seen.clear()
            bt.backtranslate(["tok5 tok6"])
            assert seen == [inside, inside]
            assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(before)


def test_get_backtranslator_builds_the_on_card_class(marian_dirs):
    tok = WordTok()
    bt = tbt.get_backtranslator(*marian_dirs, tokenizers=(tok, tok), device="cpu")
    assert isinstance(bt, tbt.JaxMarianBacktranslator) and tbt._singleton_backend == "jax"
    assert tbt.get_backtranslator() is bt
    assert tbt.get_backtranslator(backend="jax") is bt
    assert bt.backtranslate(["tok5 tok6"]) == jbt.get_backtranslator(
        *marian_dirs, tokenizers=(tok, tok)).backtranslate(["tok5 tok6"])
    # a forced backend is not masked by a memoized instance of another kind
    tbt.reset_backtranslator()
    assert isinstance(tbt.get_backtranslator(), tbt.ParaphraseBacktranslator)
    assert isinstance(tbt.get_backtranslator(backend="identity"), tbt.IdentityBacktranslator)
    forced = tbt.get_backtranslator(*marian_dirs, backend="jax", tokenizers=(tok, tok),
                                    device="cpu")
    assert isinstance(forced, tbt.JaxMarianBacktranslator)
    assert tbt.get_backtranslator() is forced


def test_device_none_needs_cuda(marian_dirs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tok = WordTok()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbt.JaxMarianBacktranslator(*marian_dirs, tokenizers=(tok, tok))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbt.get_backtranslator(*marian_dirs, backend="jax", tokenizers=(tok, tok))
    assert tbt._singleton is None
