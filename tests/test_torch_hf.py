"""Checkpoint directories across the two packages, and HF's own files.

- qst_tpu's ``save_torch_state_dict`` → a directory → the port's
  ``load_hf_checkpoint_dir``: the same embeddings as the JAX encoder (1e-5);
- the port's ``save_checkpoint_dir`` (``model.safetensors`` or
  ``pytorch_model.bin``) → qst_tpu's ``load_hf_checkpoint_dir``: the same
  embeddings, and the same config (arch, widths, max_seq_length, pooling);
- the port's safetensors reader and writer against the ``safetensors``
  package (skipped without it);
- a directory written by ``transformers``' ``save_pretrained`` (BERT and
  MPNet, random weights) loads into the port and gives the HF model's
  hidden states (skipped without ``transformers``);
- the JAX package's names for the state-dict import and export
  (``import_bert_params``, ``import_mpnet_params``,
  ``import_sentence_encoder_params``, ``export_bert_state_dict``,
  ``export_mpnet_state_dict``) between qst_tpu's param trees and the port's
  modules: the same embeddings (1e-5), and the same refusals;
- RoBERTa directories: tests/test_torch_roberta.py.

BERT and MPNet at tiny widths, f32, on the CPU.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qst_tpu.core import config as jc
from qst_tpu.models import hf_export as jexport
from qst_tpu.models import hf_import as jimport
from qst_tpu.models import mpnet as jmpnet
from qst_tpu.models.sentence_encoder import SentenceEncoderModule as JaxModule
from qst_tpu.models.sentence_encoder import init_params as jax_init_params
from qst_tpu_torch.core import config as tc
from qst_tpu_torch.models import hf_export, hf_import, mpnet
from qst_tpu_torch.models.sentence_encoder import SentenceEncoder, SentenceEncoderModule
from qst_tpu_torch.models.sentence_encoder import init_params
from qst_tpu_torch.models.tokenizer import load_tokenizer

VOCAB = ["[PAD]", "<s>", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "the", "cat", "dog", "car",
         "red", "sits", "runs", "on", "in", "mat", "park", "road", "of", "pasta", "beach",
         "plane", "sky", "people", "sand", "young", "small", "with", "sauce", "##s", "0", "1"]
TEXTS = ["a red car on the road", "the cat sits on a mat", "people in the park with a dog",
         "pasta with sauce", "a small plane in the sky of the beach", "dogs"]


def _cfgs(arch, **over):
    base = dict(name=f"t-{arch}", arch=arch, vocab_size=len(VOCAB), hidden_size=64,
                num_layers=2, num_heads=4, intermediate_size=128, max_position_embeddings=66,
                max_seq_length=24, dtype="float32", pooling="mean")
    if arch == "mpnet":
        base.update(pad_token_id=1)
    base.update(over)
    jcfg = jc.EncoderConfig(**base)
    return jcfg, tc.EncoderConfig(**dataclasses.asdict(jcfg))


def _write_vocab(d):
    with open(os.path.join(d, "vocab.txt"), "w") as f:
        f.write("\n".join(VOCAB) + "\n")


def _port_embed(cfg, sd, vocab_path):
    enc = SentenceEncoder(cfg, sd, load_tokenizer(vocab_path, vocab_size=cfg.vocab_size),
                          device="cpu")
    return enc.encode(TEXTS)


def _jax_embed(jcfg, params, vocab_path):
    from qst_tpu.models.tokenizer import load_tokenizer as jload

    ids, mask = jload(vocab_path, vocab_size=jcfg.vocab_size).batch_encode(
        TEXTS, max_length=jcfg.max_seq_length)
    out = JaxModule(jcfg).apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask))
    return np.asarray(out["sentence_embedding"])


@pytest.mark.parametrize("arch", ["bert", "mpnet"])
def test_jax_export_loads_in_the_port(tmp_path, arch):
    jcfg, cfg = _cfgs(arch)
    params = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.key(6)))
    d = str(tmp_path)
    # the directory's config and side files from the port's writer, the
    # weights from qst_tpu's exporter
    hf_export.save_checkpoint_dir({}, cfg, d, vocab=VOCAB, weights="pytorch_model.bin")
    jexport.save_torch_state_dict(params, jcfg, os.path.join(d, "pytorch_model.bin"))
    got_cfg, sd, vocab_path = hf_import.load_hf_checkpoint_dir(d)
    assert (got_cfg.arch, got_cfg.hidden_size, got_cfg.max_seq_length, got_cfg.pooling) == (
        arch, 64, 24, "mean")
    assert set(sd) == set(SentenceEncoderModule(got_cfg).state_dict())
    got = _port_embed(dataclasses.replace(got_cfg, dtype="float32"), sd, vocab_path)
    want = _jax_embed(jcfg, params, vocab_path)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("weights", ["model.safetensors", "pytorch_model.bin"])
@pytest.mark.parametrize("arch", ["bert", "mpnet"])
def test_port_export_loads_in_jax(tmp_path, arch, weights):
    if weights == "model.safetensors":
        pytest.importorskip("safetensors")   # qst_tpu reads the file with the package
    jcfg, cfg = _cfgs(arch, max_seq_length=20, pooling="cls")
    sd = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    d = hf_export.save_checkpoint_dir(sd, cfg, str(tmp_path / "ckpt"), vocab=VOCAB,
                                      weights=weights)
    jcfg2, jparams, jvocab = jimport.load_hf_checkpoint_dir(d)
    assert (jcfg2.arch, jcfg2.num_layers, jcfg2.max_seq_length, jcfg2.pooling,
            jcfg2.pad_token_id) == (arch, 2, 20, "cls", cfg.pad_token_id)
    jcfg2 = dataclasses.replace(jcfg2, dtype="float32")
    want = _jax_embed(jcfg2, jax.tree.map(np.asarray, jparams), jvocab)
    got_cfg, got_sd, vocab_path = hf_import.load_hf_checkpoint_dir(d)
    assert all(torch.equal(got_sd[k], sd[k]) for k in sd) and got_sd.keys() == sd.keys()
    got = _port_embed(dataclasses.replace(got_cfg, dtype="float32"), got_sd, vocab_path)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _named_cfgs(arch):
    """``EncoderConfig.tiny()`` for BERT, MPNet at the same tiny width."""
    jcfg = jc.EncoderConfig.tiny(**({"arch": "mpnet", "pad_token_id": 1} if arch == "mpnet"
                                    else {}))
    return jcfg, tc.EncoderConfig(**dataclasses.asdict(jcfg))


def _ids(cfg, seed):
    """Four seeded rows of token ids, the last two padded."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, cfg.vocab_size, (4, cfg.max_seq_length))
    mask = np.ones_like(ids)
    for row, n in ((2, 9), (3, 20)):
        ids[row, n:], mask[row, n:] = cfg.pad_token_id, 0
    return ids.astype(np.int32), mask.astype(np.int32)


def _both_forwards(jcfg, cfg, params, sd):
    ids, mask = _ids(cfg, 11)
    want = JaxModule(jcfg).apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask))
    model = SentenceEncoderModule(cfg)
    model.load_state_dict(sd)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    return got["sentence_embedding"].numpy(), np.asarray(want["sentence_embedding"])


@pytest.mark.parametrize("arch", ["bert", "mpnet"])
def test_jax_named_import_gives_the_jax_forward(arch):
    """qst_tpu's ``init_params`` tree → its ``export_*_state_dict`` → the
    port's ``import_*`` under the JAX names → the port's module: the JAX
    forward's embeddings within 1e-5 at f32. A pooler and a
    sentence-transformers prefix are dropped as the source drops them."""
    jcfg, cfg = _named_cfgs(arch)
    params = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.key(7)))
    hf = (jexport.export_bert_state_dict if arch == "bert"
          else jexport.export_mpnet_state_dict)(params, jcfg)
    hf["pooler.dense.weight"] = np.zeros((cfg.hidden_size, cfg.hidden_size), np.float32)
    named = (hf_import.import_bert_params if arch == "bert" else mpnet.import_mpnet_params)
    sd = named(hf, cfg)
    assert list(sd) == list(SentenceEncoderModule(cfg).state_dict())
    dispatched = hf_import.import_sentence_encoder_params(
        {"0.auto_model." + k: torch.from_numpy(v) for k, v in hf.items()}, cfg)
    assert dispatched.keys() == sd.keys() and all(torch.equal(sd[k], dispatched[k]) for k in sd)
    got, want = _both_forwards(jcfg, cfg, params, sd)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch", ["bert", "mpnet"])
def test_jax_named_export_loads_in_jax(arch):
    """The port's weights → its ``export_*_state_dict`` under the JAX names →
    qst_tpu's ``import_sentence_encoder_params``: the same embeddings, and the
    same arrays as qst_tpu's own export of that tree."""
    jcfg, cfg = _named_cfgs(arch)
    sd = init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    export = hf_export.export_bert_state_dict if arch == "bert" else hf_export.export_mpnet_state_dict
    hf = export({**sd, "classifier.weight": torch.zeros(1, cfg.hidden_size)}, cfg)
    assert list(hf) == list(sd) and all(v.dtype == np.float32 for v in hf.values())
    params = jax.tree.map(np.asarray, jimport.import_sentence_encoder_params(hf, jcfg))
    again = (jexport.export_bert_state_dict if arch == "bert"
             else jexport.export_mpnet_state_dict)(params, jcfg)
    assert again.keys() == hf.keys() and all(np.array_equal(again[k], hf[k]) for k in hf)
    got, want = _both_forwards(jcfg, cfg, params, sd)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_jax_named_import_and_export_refuse_what_the_source_refuses():
    """An MPNet state dict for BERT and the reverse, fewer layers than the
    config's, and no trunk at all: KeyError from the port's function where
    the JAX function raises KeyError; a width other than the config's:
    ValueError (the JAX reshape raises too)."""
    (jb, tb), (jm, tm) = _named_cfgs("bert"), _named_cfgs("mpnet")
    hb = jexport.export_bert_state_dict(
        jax.tree.map(np.asarray, jax_init_params(jb, jax.random.key(1))), jb)
    hm = jexport.export_mpnet_state_dict(
        jax.tree.map(np.asarray, jax_init_params(jm, jax.random.key(2))), jm)
    one_layer = {k: v for k, v in hb.items() if ".layer.1." not in k}
    cases = [(hm, jimport.import_bert_params, hf_import.import_bert_params, jb, tb),
             (hb, jmpnet.import_mpnet_params, mpnet.import_mpnet_params, jm, tm),
             (one_layer, jimport.import_bert_params, hf_import.import_bert_params, jb, tb),
             ({"x.weight": hb["embeddings.LayerNorm.weight"]}, jimport.import_bert_params,
              hf_import.import_bert_params, jb, tb)]
    for sd, jfn, tfn, jcfg, cfg in cases:
        with pytest.raises(KeyError):
            jfn(sd, jcfg)
        with pytest.raises(KeyError):
            tfn(sd, cfg)
    with pytest.raises(KeyError):
        jexport.export_bert_state_dict(jimport.import_sentence_encoder_params(hm, jm), jb)
    with pytest.raises(KeyError):
        hf_export.export_bert_state_dict(mpnet.import_mpnet_params(hm, tm), tb)
    wide = dataclasses.replace(tb, hidden_size=128, intermediate_size=256)
    with pytest.raises(ValueError):
        jimport.import_bert_params(hb, dataclasses.replace(jb, hidden_size=128))
    with pytest.raises(ValueError, match="shapes differ"):
        hf_import.import_bert_params(hb, wide)


def test_weights_may_sit_under_a_module_directory(tmp_path):
    _, cfg = _cfgs("mpnet")
    sd = init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    inner = str(tmp_path / "0_Transformer")
    hf_export.save_checkpoint_dir(sd, cfg, inner, vocab=VOCAB)
    os.rename(os.path.join(inner, "1_Pooling"), str(tmp_path / "1_Pooling"))
    got_cfg, got_sd, vocab = hf_import.load_hf_checkpoint_dir(str(tmp_path))
    assert got_cfg.arch == "mpnet" and vocab == os.path.join(inner, "vocab.txt")
    assert all(torch.equal(got_sd[k], sd[k]) for k in sd)


def test_safetensors_reader_and_writer_match_the_package(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    tensors = {"a.f32": torch.randn(3, 5), "b.f16": torch.randn(7).half(),
               "c.bf16": torch.randn(2, 2, 3).bfloat16(), "d.i64": torch.arange(6).reshape(2, 3),
               "e.scalar": torch.tensor(2.5)}
    path = str(tmp_path / "x.safetensors")
    st.save_file(tensors, path, metadata={"format": "pt"})
    got = hf_import.read_safetensors(path)
    assert set(got) == set(tensors)
    for k, v in tensors.items():
        want = v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
        np.testing.assert_array_equal(got[k], want, err_msg=k)
    out = str(tmp_path / "y.safetensors")
    arrays = {k: v.float().numpy() for k, v in tensors.items()}
    hf_import.write_safetensors(arrays, out)
    back = st.load_file(out)
    assert set(back) == set(arrays)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


def test_load_torch_state_dict_strips_prefixes_and_drops_the_pooler(tmp_path):
    _, cfg = _cfgs("mpnet")
    sd = init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    raw = {f"mpnet.{k}": v for k, v in sd.items()}
    raw["pooler.dense.weight"] = torch.zeros(2, 2)
    raw["mpnet.embeddings.position_ids"] = torch.arange(66)[None]
    path = str(tmp_path / "w.bin")
    torch.save(raw, path)
    got = hf_import.load_torch_state_dict(path)
    assert got.keys() == sd.keys()


@pytest.mark.parametrize("arch", ["bert", "mpnet"])
def test_transformers_directory_gives_the_hf_hidden_states(tmp_path, arch):
    transformers = pytest.importorskip("transformers")
    kw = dict(vocab_size=len(VOCAB), hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
              intermediate_size=64, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    torch.manual_seed(11)
    if arch == "bert":
        hf = transformers.BertModel(transformers.BertConfig(max_position_embeddings=32, **kw),
                                    add_pooling_layer=False)
    else:
        hf = transformers.MPNetModel(transformers.MPNetConfig(max_position_embeddings=34,
                                                              pad_token_id=1, **kw),
                                     add_pooling_layer=False)
    hf.eval().save_pretrained(str(tmp_path))
    cfg, sd, _ = hf_import.load_hf_checkpoint_dir(str(tmp_path))
    cfg = dataclasses.replace(cfg, dtype="float32", hidden_dropout=0.0, attention_dropout=0.0)
    assert cfg.arch == arch
    model = SentenceEncoderModule(cfg)
    model.load_state_dict(sd)
    model.eval()
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(2, len(VOCAB), (3, 16))).long()
    mask = torch.ones((3, 16), dtype=torch.long)
    mask[1, 9:] = 0
    if arch == "mpnet":
        ids[1, 9:] = 1       # MPNet's positions count the non-pad ids
    with torch.no_grad():
        want = hf(input_ids=ids, attention_mask=mask).last_hidden_state
        got = model(ids, mask)["token_embeddings"]
    rows = mask.bool()
    np.testing.assert_allclose(got[rows].numpy(), want[rows].numpy(), rtol=0, atol=1e-5)
