"""RoBERTa, the cross-encoder and two-stage retrieval in the port, against
qst_tpu.

- the trunk (``BertEncoder`` with ``arch="roberta"``: padding-aware
  positions, one token-type row taking segment 1 too) against JAX's on
  padded batches, and ``SentenceEncoder`` with CLS pooling behind the BPE
  tokenizer, 1e-5 at f32;
- the gradients of one loss and one ``make_train_step`` step at dropout 0
  against JAX's (gradients 1e-5 of each tensor's largest value);
- the flash path (``use_flash_attention`` at S = 128, K7/K8's plain
  versions on the CPU) against the einsum path, forward and gradients;
- ``CrossEncoderModule`` with both heads and ``CrossEncoder.predict`` (n
  below and above ``batch_size``, and 0 pairs) against JAX's, 1e-5;
- checkpoint directories: written by the JAX side and by ``transformers``
  (``RobertaModel`` / ``RobertaForSequenceClassification`` /
  ``BertForSequenceClassification.save_pretrained``), read by the port;
  written by the port, read by JAX and ``transformers``;
- ``Retriever.search(rerank_k=)`` against JAX's with one shared stub
  reranker and with tiny real cross-encoders, static and updatable, and its
  two ``RuntimeError``s;
- ``ir_eval_main --use_cross_encoder --cross_encoder_dir`` against the JAX
  CLI: the same relevant sets and metrics within 1e-6;
- on a GPU (``cuda`` marker, skipped here): K7 at RoBERTa-large's view
  (16 heads of 64, sequence stride 1,024) against its plain version, and a
  cross-encoder through K7 against its einsum path.

Weights come from JAX ``init_params`` / ``init_cross_encoder`` and go into
the port through ``state_dict_from_flax_params``; inputs are numpy arrays
fed to both packages.
"""

import dataclasses
import json
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpe_helpers import TEXTS, learn_bpe, write_bpe_files
from qst_tpu.core import config as jc
from qst_tpu.models import cross_encoder as jce
from qst_tpu.models import hf_import as jimport
from qst_tpu.models.bert import BertEncoder as JaxBertEncoder
from qst_tpu.models.bpe_tokenizer import RobertaBPETokenizer as JaxBPE
from qst_tpu.models.sentence_encoder import SentenceEncoder as JaxSentenceEncoder
from qst_tpu.models.sentence_encoder import SentenceEncoderModule as JaxModule
from qst_tpu.models.sentence_encoder import init_params as jax_init_params
from qst_tpu.train import train_step as jts
from qst_tpu_torch.core import config as tc
from qst_tpu_torch.models import cross_encoder as tce
from qst_tpu_torch.models import hf_export, hf_import
from qst_tpu_torch.models.bert import BertEncoder
from qst_tpu_torch.models.bpe_tokenizer import RobertaBPETokenizer
from qst_tpu_torch.models.hf_import import state_dict_from_flax_params
from qst_tpu_torch.models.sentence_encoder import (SentenceEncoder, SentenceEncoderModule,
                                                   init_state_dict)
from qst_tpu_torch.train import train_step as tts

ATOL = 1e-5
DOCS = [t + f" — note {i}" for i, t in enumerate(TEXTS * 3)]
QUERIES = ["a dog in the park", "pasta sauce", "a plane over the sea", "cats in the sun"]


@pytest.fixture(scope="module")
def bpe_dir(tmp_path_factory):
    vocab, merges = learn_bpe(TEXTS, 200)
    d = str(tmp_path_factory.mktemp("bpe"))
    return write_bpe_files(d, vocab, merges), vocab, merges


def _cfgs(vocab_size, arch="roberta", **over):
    base = dict(name=f"t-{arch}", arch=arch, vocab_size=vocab_size, hidden_size=32,
                num_layers=2, num_heads=4, intermediate_size=64, max_position_embeddings=40,
                max_seq_length=24, dtype="float32", hidden_dropout=0.0, attention_dropout=0.0,
                normalize=False, pooling="cls")
    if arch == "roberta":
        base.update(type_vocab_size=1, layer_norm_eps=1e-5, pad_token_id=1)
    base.update(over)
    return jc.EncoderConfig(**base), tc.EncoderConfig(**base)


def _padded(rng, B, S, vocab, pad=1):
    ids = rng.integers(5, vocab, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[0, S * 2 // 3:] = 0
    mask[2, 3:] = 0
    ids[mask == 0] = pad          # the positions count the ids that are not pad
    types = np.zeros_like(ids)
    types[:, S // 2:] = 1         # a pair tokenizer's segment 1: one row takes it
    return ids, mask, types


@pytest.fixture(scope="module")
def roberta(bpe_dir):
    _, vocab, _ = bpe_dir
    jcfg, cfg = _cfgs(len(vocab))
    params = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.key(3)))
    return jcfg, cfg, params, state_dict_from_flax_params(params, cfg)


def _module(cls, cfg, sd):
    m = cls(cfg)
    m.load_state_dict(sd)
    return m.eval()


def test_trunk_matches_jax_roberta(roberta):
    jcfg, cfg, params, sd = roberta
    ids, mask, types = _padded(np.random.default_rng(0), 4, 24, cfg.vocab_size)
    want = np.asarray(JaxBertEncoder(jcfg).apply({"params": params["encoder"]}, jnp.asarray(ids),
                                                  jnp.asarray(mask), jnp.asarray(types)))
    trunk = _module(BertEncoder, cfg, sd)
    with torch.no_grad():
        got = trunk(torch.from_numpy(ids).long(), torch.from_numpy(mask).long(),
                    torch.from_numpy(types).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # the positions are RoBERTa's: BERT's (1, S) positions give another answer
    with torch.no_grad():
        bert = BertEncoder(dataclasses.replace(cfg, arch="bert"))
        bert.load_state_dict(trunk.state_dict())
        other = bert.eval()(torch.from_numpy(ids).long(), torch.from_numpy(mask).long()).numpy()
    assert np.abs(other - want).max() > 1e-2


def test_sentence_encoder_cls_pooling_matches_jax(roberta, bpe_dir):
    jcfg, cfg, params, sd = roberta
    path = bpe_dir[0]
    want = JaxSentenceEncoder(jcfg, params, JaxBPE.from_files(path)).encode(DOCS, batch_size=8)
    got = SentenceEncoder(cfg, sd, RobertaBPETokenizer.from_files(path), device="cpu").encode(
        DOCS, batch_size=8)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_gradients_match_jax(roberta):
    """d/dθ of Σ w·embedding, the port's autograd against ``jax.grad``:
    within 1e-5 of each tensor's largest value."""
    jcfg, cfg, params, sd = roberta
    ids, mask, _ = _padded(np.random.default_rng(1), 4, 24, cfg.vocab_size)
    w = np.random.default_rng(2).standard_normal((4, cfg.hidden_size)).astype(np.float32)

    def jloss(p):
        out = JaxModule(jcfg).apply({"params": p}, jnp.asarray(ids), jnp.asarray(mask))
        return (out["sentence_embedding"] * w).sum()

    jgrads = state_dict_from_flax_params(jax.tree.map(np.asarray, jax.grad(jloss)(params)), cfg)
    model = _module(SentenceEncoderModule, cfg, sd)
    out = model(torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    (out["sentence_embedding"] * torch.from_numpy(w)).sum().backward()
    for name, p in model.named_parameters():
        # the key bias's gradient is zero up to rounding (softmax ignores a
        # constant added to a row): held to the query bias's scale
        scale = jgrads[name.replace("self.key.bias", "self.query.bias")].abs().max().item()
        np.testing.assert_allclose(p.grad.numpy(), jgrads[name].numpy(), rtol=0,
                                   atol=ATOL * scale, err_msg=name)


def test_train_step_matches_jax_make_train_step(roberta):
    """One step at dropout 0 with unit-norm embeddings (unnormalized CLS
    rows make the last LayerNorm's bias a shift that no distance sees, whose
    gradient is rounding noise that Adam turns into a full step)."""
    jcfg, cfg, params, sd = roberta
    jcfg, cfg = (dataclasses.replace(c, normalize=True) for c in (jcfg, cfg))
    jl = jc.LossConfig(margin_pos_part=0.5, margin_part_neg=0.5)
    jt = jc.TrainConfig(batch_size=2, learning_rate=1e-3, scheduler="constantlr",
                        max_grad_norm=0.5)
    tl, tt = tc.LossConfig(**dataclasses.asdict(jl)), tc.TrainConfig(**dataclasses.asdict(jt))
    sj, tx = jts.create_train_state(jcfg, jt, jax.random.key(0), 10, jl, initial_params=params)
    st, _ = tts.create_train_state(cfg, tt, torch.Generator().manual_seed(0), 10, tl,
                                   initial_params=sd, device="cpu")
    ids, mask, _ = _padded(np.random.default_rng(3), 8, 24, cfg.vocab_size)
    ids, mask = ids.reshape(4, 2, 24), mask.reshape(4, 2, 24)
    sj, lj = jts.make_train_step(jcfg, jl, tx)(sj, jnp.asarray(ids), jnp.asarray(mask),
                                               jax.random.key(1))
    st, lt = tts.make_train_step(cfg, tl)(st, ids, mask, None)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    want = state_dict_from_flax_params(jax.tree.map(np.asarray, sj.params), cfg)
    got = st.model.state_dict()
    for k, v in want.items():
        # Adam turns the key bias's rounding-noise gradient into a full
        # step of either sign (tests/test_torch_mpnet.py holds it alike)
        atol = 2 * jt.learning_rate if k.endswith("self.key.bias") else 0.1 * jt.learning_rate
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=atol, err_msg=k)


def test_flash_path_matches_the_einsum_path(bpe_dir):
    """``use_flash_attention`` at S = 128 (the cross-encoder's length):
    RoBERTa's attention through ``FlashAttention`` (K7/K8's plain versions
    here, one call a layer) gives the einsum path's pooled embedding and
    gradients within 1e-5."""
    from qst_tpu_torch.ops import flash_attention as tfa

    _, cfg = _cfgs(len(bpe_dir[1]), max_position_embeddings=160, max_seq_length=128)
    sd = init_state_dict(SentenceEncoderModule(cfg), torch.Generator().manual_seed(4), "cpu")
    ids, mask, _ = _padded(np.random.default_rng(4), 3, 128, cfg.vocab_size)
    w = torch.randn((3, cfg.hidden_size), generator=torch.Generator().manual_seed(5))
    calls = []
    real = tfa.FlashAttention.apply
    out = {}
    for flash in (False, True):
        model = _module(SentenceEncoderModule, dataclasses.replace(cfg, use_flash_attention=flash),
                        sd)
        tfa.FlashAttention.apply = lambda *a: calls.append(1) or real(*a)
        try:
            emb = model(torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
        finally:
            tfa.FlashAttention.apply = real
        (emb["sentence_embedding"] * w).sum().backward()
        out[flash] = (emb["sentence_embedding"].detach(),
                      {n: p.grad for n, p in model.named_parameters()})
    assert len(calls) == cfg.num_layers
    torch.testing.assert_close(out[True][0], out[False][0], rtol=0, atol=ATOL)
    for n, g in out[False][1].items():
        scale = out[False][1][n.replace("self.key.bias", "self.query.bias")].abs().max().item()
        torch.testing.assert_close(out[True][1][n], g, rtol=0, atol=ATOL * scale, msg=n)


# ------------------------------------------------------------ cross-encoder
def _cross(arch, vocab_size, tok=None, key=5, **over):
    """JAX ``init_cross_encoder`` params and the port's state dict of them;
    with ``tok`` (RoBERTa), the head spread by ``_spread`` in both."""
    jcfg, cfg = _cfgs(vocab_size, arch=arch, **over)
    params = jax.tree.map(np.asarray, jce.init_cross_encoder(jcfg, jax.random.key(key)))
    sd = state_dict_from_flax_params(params, cfg)
    if tok is not None:
        sd = _spread(sd, cfg, tok)
        params["out_proj"] = {"kernel": sd["classifier.out_proj.weight"].numpy().T,
                              "bias": sd["classifier.out_proj.bias"].numpy()}
    return jcfg, cfg, params, sd


def _spread(ce_sd, cfg, tok):
    """Rescale the head's last layer so that the logits over the tests'
    (query, doc) pairs are about N(−0.4, 10²): a random trunk gives every
    pair nearly the same CLS row, and the relevance threshold 0.4 should
    split the pairs."""
    model = _module(tce.CrossEncoderModule, cfg, ce_sd)
    ids, mask, types = tok.batch_encode_pairs([(q, d) for q in QUERIES for d in DOCS],
                                              cfg.max_seq_length)
    with torch.no_grad():
        logits = model(*(torch.from_numpy(a).long() for a in (ids, mask, types)))
    s = 10.0 / logits.std().item()
    ce_sd["classifier.out_proj.weight"] *= s
    ce_sd["classifier.out_proj.bias"] = ce_sd["classifier.out_proj.bias"] * s - (
        logits.mean() * s + 0.4).reshape(1)
    return ce_sd


def test_cross_encoder_state_dict_is_hf_sequence_classification():
    for arch, head in (("roberta", {"classifier.dense.weight", "classifier.dense.bias",
                                    "classifier.out_proj.weight", "classifier.out_proj.bias"}),
                       ("bert", {"classifier.weight", "classifier.bias"})):
        _, cfg = _cfgs(300, arch=arch)
        keys = set(tce.CrossEncoderModule(cfg).state_dict())
        assert keys == set(SentenceEncoderModule(cfg).state_dict()) | head
        sd = tce.init_cross_encoder(cfg, torch.Generator().manual_seed(0), device="cpu")
        assert set(sd) == keys and not sd["classifier.bias" if arch == "bert"
                                          else "classifier.out_proj.bias"].any()


@pytest.mark.parametrize("arch", ["roberta", "bert"])
def test_cross_encoder_module_matches_jax(arch):
    jcfg, cfg, params, sd = _cross(arch, 300)
    ids, mask, types = _padded(np.random.default_rng(6), 5, 24, 300)
    want = np.asarray(jce.CrossEncoderModule(jcfg).apply(
        {"params": params}, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(types)))
    with torch.no_grad():
        got = _module(tce.CrossEncoderModule, cfg, sd)(
            torch.from_numpy(ids).long(), torch.from_numpy(mask).long(),
            torch.from_numpy(types).long())
    assert got.shape == (5,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("n", [0, 3, 4, 11])
def test_predict_matches_jax(bpe_dir, n):
    """batch_size 4: one short chunk, one full, and three chunks with a
    padded last one; 0 pairs give (0,) f32."""
    path, vocab, _ = bpe_dir
    jcfg, cfg, params, sd = _cross("roberta", len(vocab), RobertaBPETokenizer.from_files(path))
    pairs = [(QUERIES[i % 4], DOCS[i]) for i in range(n)]
    want = jce.CrossEncoder(jcfg, params, JaxBPE.from_files(path)).predict(pairs, batch_size=4)
    got = tce.CrossEncoder(cfg, sd, RobertaBPETokenizer.from_files(path), device="cpu").predict(
        pairs, batch_size=4)
    assert got.shape == want.shape == (n,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


# -------------------------------------------------------------- directories
def _hf_roberta_config(cfg):
    return dict(vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
                num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
                intermediate_size=cfg.intermediate_size,
                max_position_embeddings=cfg.max_position_embeddings, type_vocab_size=1,
                layer_norm_eps=1e-5, pad_token_id=1, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0)


def test_jax_written_roberta_directory_loads(tmp_path, roberta, bpe_dir):
    """qst_tpu's ``save_torch_state_dict`` + a RoBERTa ``config.json`` and
    the BPE files: ``load_hf_checkpoint_dir`` finds ``vocab.json``, the
    config (type_vocab_size 1 by default) and weights that embed as JAX."""
    from qst_tpu.models.hf_export import save_torch_state_dict as jax_save

    jcfg, cfg, params, _ = roberta
    d = str(tmp_path / "jax_roberta")
    os.makedirs(d)
    jax_save(params, jcfg, os.path.join(d, "pytorch_model.bin"))
    hf_cfg = _hf_roberta_config(cfg)
    hf_cfg.pop("type_vocab_size")
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(dict(hf_cfg, model_type="roberta"), f)
    write_bpe_files(d, bpe_dir[1], bpe_dir[2])
    got_cfg, sd, vocab = hf_import.load_hf_checkpoint_dir(d)
    want_cfg, _, jvocab = jimport.load_hf_checkpoint_dir(d)
    assert (got_cfg.arch, got_cfg.type_vocab_size, got_cfg.pad_token_id) == ("roberta", 1, 1)
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(want_cfg) and vocab == jvocab
    assert vocab.endswith("vocab.json")
    from qst_tpu_torch.models.tokenizer import load_tokenizer

    tok = load_tokenizer(vocab)
    assert isinstance(tok, RobertaBPETokenizer)
    run_cfg = dataclasses.replace(got_cfg, dtype="float32", pooling="cls", normalize=False)
    want = JaxSentenceEncoder(dataclasses.replace(jcfg, max_seq_length=run_cfg.max_seq_length),
                              params, JaxBPE.from_files(vocab)).encode(DOCS)
    got = SentenceEncoder(run_cfg, sd, tok, device="cpu").encode(DOCS)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_transformers_roberta_directories_load(tmp_path, bpe_dir):
    """``RobertaModel.save_pretrained`` → ``load_hf_checkpoint_dir``: the HF
    hidden states; ``RobertaForSequenceClassification.save_pretrained`` →
    ``load_cross_encoder_dir``: HF's sigmoid scores, and JAX's loader's."""
    transformers = pytest.importorskip("transformers")
    path, vocab, merges = bpe_dir
    _, cfg = _cfgs(len(vocab))
    torch.manual_seed(12)
    hf_cfg = transformers.RobertaConfig(**_hf_roberta_config(cfg))
    trunk = transformers.RobertaModel(hf_cfg, add_pooling_layer=False).eval()
    trunk.save_pretrained(str(tmp_path / "trunk"))
    head = transformers.RobertaForSequenceClassification(
        transformers.RobertaConfig(num_labels=1, **_hf_roberta_config(cfg))).eval()
    head.save_pretrained(str(tmp_path / "ce"))
    write_bpe_files(str(tmp_path / "ce"), vocab, merges)
    ids, mask, _ = _padded(np.random.default_rng(7), 4, 24, cfg.vocab_size)

    got_cfg, sd, _ = hf_import.load_hf_checkpoint_dir(str(tmp_path / "trunk"))
    trunk_module = _module(SentenceEncoderModule, dataclasses.replace(got_cfg, dtype="float32"), sd)
    with torch.no_grad():
        want = trunk(input_ids=torch.from_numpy(ids).long(),
                     attention_mask=torch.from_numpy(mask).long()).last_hidden_state
        got = trunk_module(torch.from_numpy(ids).long(),
                           torch.from_numpy(mask).long())["token_embeddings"]
    m = torch.from_numpy(mask).bool()
    torch.testing.assert_close(got[m], want[m], rtol=0, atol=1e-4)

    ce_cfg, ce_sd, ce_vocab = hf_import.load_cross_encoder_dir(str(tmp_path / "ce"),
                                                               max_seq_length=24)
    assert ce_cfg.max_seq_length == 24 and ce_vocab.endswith("vocab.json")
    ce_cfg = dataclasses.replace(ce_cfg, dtype="float32")
    pairs = [(q, d) for q in QUERIES for d in DOCS[:5]]
    got = tce.CrossEncoder(ce_cfg, ce_sd, RobertaBPETokenizer.from_files(ce_vocab),
                           device="cpu").predict(pairs, batch_size=8)
    ids, mask, types = RobertaBPETokenizer.from_files(ce_vocab).batch_encode_pairs(pairs, 24)
    with torch.no_grad():
        hf_scores = torch.sigmoid(head(input_ids=torch.from_numpy(ids).long(),
                                       attention_mask=torch.from_numpy(mask).long()).logits[:, 0])
    np.testing.assert_allclose(got, hf_scores.numpy(), rtol=0, atol=1e-4)
    jcfg, jparams, _ = jimport.load_cross_encoder_dir(str(tmp_path / "ce"), max_seq_length=24)
    jwant = jce.CrossEncoder(dataclasses.replace(jcfg, dtype="float32"), jparams,
                             JaxBPE.from_files(ce_vocab)).predict(pairs, batch_size=8)
    np.testing.assert_allclose(got, jwant, rtol=0, atol=ATOL)


def test_transformers_bert_cross_encoder_directory_loads_as_jax(tmp_path):
    """``BertForSequenceClassification``'s directory: the trunk and the one
    ``classifier`` load (the pooler is dropped, as the source drops it: its
    head reads the CLS row), scores equal to JAX's loader's."""
    transformers = pytest.importorskip("transformers")
    from qst_tpu.models.tokenizer import HashTokenizer as JaxHash
    from qst_tpu_torch.models.tokenizer import HashTokenizer

    torch.manual_seed(13)
    hf = transformers.BertForSequenceClassification(transformers.BertConfig(
        num_labels=1, vocab_size=512, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, max_position_embeddings=40))
    hf.save_pretrained(str(tmp_path / "bert_ce"))
    cfg, sd, vocab = hf_import.load_cross_encoder_dir(str(tmp_path / "bert_ce"), 24)
    assert vocab is None and "classifier.weight" in sd and not any("pooler" in k for k in sd)
    pairs = [(q, d) for q in QUERIES for d in DOCS[:3]]
    got = tce.CrossEncoder(dataclasses.replace(cfg, dtype="float32"), sd, HashTokenizer(512),
                           device="cpu").predict(pairs, batch_size=8)
    jcfg, jparams, _ = jimport.load_cross_encoder_dir(str(tmp_path / "bert_ce"), 24)
    want = jce.CrossEncoder(dataclasses.replace(jcfg, dtype="float32"), jparams,
                            JaxHash(512)).predict(pairs, batch_size=8)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("weights", ["model.safetensors", "pytorch_model.bin"])
def test_port_written_directories_load_in_jax_and_transformers(tmp_path, bpe_dir, weights):
    """``save_checkpoint_dir`` (RoBERTa, CLS pooling, BPE files) → JAX's
    ``load_hf_checkpoint_dir``: its config and the port's embeddings;
    ``save_cross_encoder_dir`` → JAX's ``load_cross_encoder_dir`` and
    ``transformers``' ``from_pretrained``: the port's scores."""
    path, vocab, merges = bpe_dir
    _, cfg = _cfgs(len(vocab))
    sd = init_state_dict(SentenceEncoderModule(cfg), torch.Generator().manual_seed(8), "cpu")
    d = hf_export.save_checkpoint_dir(sd, cfg, str(tmp_path / "bi"), vocab=vocab,
                                      weights=weights, merges=merges)
    jcfg, jparams, jvocab = jimport.load_hf_checkpoint_dir(d)
    assert (jcfg.arch, jcfg.type_vocab_size, jcfg.pooling, jcfg.max_seq_length) == (
        "roberta", 1, "cls", 24) and jvocab.endswith("vocab.json")
    jcfg = dataclasses.replace(jcfg, dtype="float32", normalize=False)
    want = JaxSentenceEncoder(jcfg, jparams, JaxBPE.from_files(jvocab)).encode(DOCS)
    got = SentenceEncoder(cfg, sd, RobertaBPETokenizer.from_files(path), device="cpu").encode(DOCS)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)

    ce_sd = _spread(tce.init_cross_encoder(cfg, torch.Generator().manual_seed(9), device="cpu"),
                    cfg, RobertaBPETokenizer.from_files(path))
    ce_dir = hf_export.save_cross_encoder_dir(ce_sd, cfg, str(tmp_path / "ce"), vocab=vocab,
                                              weights=weights, merges=merges)
    pairs = [(q, d) for q in QUERIES for d in DOCS[:6]]
    got = tce.CrossEncoder(cfg, ce_sd, RobertaBPETokenizer.from_files(path),
                           device="cpu").predict(pairs, batch_size=8)
    again_cfg, again_sd, _ = hf_import.load_cross_encoder_dir(ce_dir, max_seq_length=24)
    assert all(torch.equal(again_sd[k], v) for k, v in ce_sd.items())
    jcfg, jparams, jvocab = jimport.load_cross_encoder_dir(ce_dir, max_seq_length=24)
    want = jce.CrossEncoder(dataclasses.replace(jcfg, dtype="float32"), jparams,
                            JaxBPE.from_files(jvocab)).predict(pairs, batch_size=8)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert got.std() > 0.05
    transformers = pytest.importorskip("transformers")
    hf = transformers.RobertaForSequenceClassification.from_pretrained(ce_dir).eval()
    ids, mask, _ = RobertaBPETokenizer.from_files(path).batch_encode_pairs(pairs, 24)
    with torch.no_grad():
        hf_scores = torch.sigmoid(hf(input_ids=torch.from_numpy(ids).long(),
                                     attention_mask=torch.from_numpy(mask).long()).logits[:, 0])
    np.testing.assert_allclose(got, hf_scores.numpy(), rtol=0, atol=1e-4)


# ----------------------------------------------------------------- reranking
class _HashEncoder:
    def encode(self, texts):
        from helpers import hash_embed

        return hash_embed(list(texts))


class _StubReranker:
    """Scores a pair by a hash of its texts; records the pairs it saw."""

    def __init__(self):
        self.seen = []

    def predict(self, pairs):
        self.seen.append(list(pairs))
        return np.array([zlib.crc32(f"{q}|{d}".encode()) % 1000 / 1000 for q, d in pairs],
                        np.float32)


def _retrievers(reranker_j, reranker_t, updatable: bool):
    from qst_tpu.retrieval import Retriever as JaxRetriever
    from qst_tpu_torch.retrieval import Retriever

    j = JaxRetriever(_HashEncoder(), reranker=reranker_j)
    t = Retriever(_HashEncoder(), reranker=reranker_t, device="cpu")
    ids = [f"doc{i}" for i in range(len(DOCS))]
    if updatable:
        j.build_updatable(DOCS[:-4], ids=ids[:-4], capacity=64)
        t.build_updatable(DOCS[:-4], ids=ids[:-4], capacity=64)
        for r in (j, t):
            r.add_docs(DOCS[-4:], ids=ids[-4:])
            r.remove_docs(["doc3"])
    else:
        j.build(DOCS, ids=ids)
        t.build(DOCS, ids=ids)
    return j, t


def _same_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [e[0] for e in g] == [e[0] for e in w]
        assert [e[2:] for e in g] == [e[2:] for e in w]
        np.testing.assert_allclose([e[1] for e in g], [e[1] for e in w], rtol=0, atol=ATOL)


@pytest.mark.parametrize("updatable", [False, True], ids=["static", "updatable"])
@pytest.mark.parametrize("k,rerank_k", [(3, 8), (5, 2)])
def test_rerank_matches_jax_with_one_stub(updatable, k, rerank_k):
    stub = _StubReranker()
    j, t = _retrievers(stub, stub, updatable)
    for texts in (False, True):
        want = j.search(QUERIES, k=k, return_texts=texts, rerank_k=rerank_k)
        n_j = len(stub.seen)
        got = t.search(QUERIES, k=k, return_texts=texts, rerank_k=rerank_k)
        assert stub.seen[n_j:] == stub.seen[:n_j][-len(QUERIES):]      # the same pairs asked
        assert all(len(p) == max(k, rerank_k) for p in stub.seen)
        _same_rows(got, want)
        assert all(len(r) == k for r in got)


@pytest.mark.parametrize("updatable", [False, True], ids=["static", "updatable"])
def test_rerank_with_tiny_cross_encoders_matches_jax(bpe_dir, updatable):
    path, vocab, _ = bpe_dir
    jcfg, cfg, params, sd = _cross("roberta", len(vocab), RobertaBPETokenizer.from_files(path))
    j, t = _retrievers(jce.CrossEncoder(jcfg, params, JaxBPE.from_files(path)),
                       tce.CrossEncoder(cfg, sd, RobertaBPETokenizer.from_files(path),
                                        device="cpu"), updatable)
    want = j.search(QUERIES, k=4, return_texts=True, rerank_k=10)
    got = t.search(QUERIES, k=4, return_texts=True, rerank_k=10)
    _same_rows(got, want)
    plain = t.search(QUERIES, k=4)
    assert [[e[0] for e in r] for r in got] != [[e[0] for e in r] for r in plain]


def test_rerank_errors_are_the_sources():
    from qst_tpu.retrieval import ExactIndex as JaxExactIndex
    from qst_tpu.retrieval import Retriever as JaxRetriever
    from qst_tpu_torch.retrieval import ExactIndex, Retriever

    for r in (JaxRetriever(_HashEncoder()), Retriever(_HashEncoder(), device="cpu")):
        with pytest.raises(RuntimeError, match="no index built or loaded"):
            r.search(QUERIES, rerank_k=3)
        r.build(DOCS)
        with pytest.raises(RuntimeError, match="no reranker configured"):
            r.search(QUERIES, rerank_k=3)
    emb = _HashEncoder().encode(DOCS)
    for r, idx in ((JaxRetriever(_HashEncoder(), reranker=_StubReranker()), JaxExactIndex(emb)),
                   (Retriever(_HashEncoder(), reranker=_StubReranker(), device="cpu"),
                    ExactIndex(emb, device="cpu"))):
        r.index = idx
        with pytest.raises(RuntimeError, match=r"reranking needs doc texts \(build\(\) them\)"):
            r.search(QUERIES, rerank_k=3)
        assert len(r.search(QUERIES, k=2)[0]) == 2


# ------------------------------------------------------------------ the CLI
def test_ir_eval_cli_cross_encoder_dir_matches_the_jax_cli(tmp_path, bpe_dir, monkeypatch):
    """Both CLIs with ``--use_cross_encoder --cross_encoder_dir`` (a RoBERTa
    cross-encoder written by the port, its BPE files) over one dataset, with
    the tiny preset's baseline weights from one file: the same eval set
    (relevant sets included) and metrics within 1e-6. The directory's
    config runs in bf16 by default; both loaders are held to f32 here, the
    precision the parity is claimed at."""
    from helpers import write_synthetic_dataset
    from qst_tpu.cli import ir_eval_main as jir_main
    from qst_tpu.models import hf_export as jexport
    from qst_tpu_torch.cli import ir_eval_main as tir_main

    data = str(tmp_path / "data")
    write_synthetic_dataset(data, n_chunks=4, chunk_dim=12)
    jcfg = jc.EncoderConfig.tiny()
    jexport.save_torch_state_dict(jax_init_params(jcfg, jax.random.key(21)), jcfg,
                                  str(tmp_path / "baseline.bin"))
    _, vocab, merges = bpe_dir
    _, cfg = _cfgs(len(vocab), max_position_embeddings=40)
    ce_sd = _spread(tce.init_cross_encoder(cfg, torch.Generator().manual_seed(22), device="cpu"),
                    cfg, RobertaBPETokenizer(vocab, merges))
    ce_dir = hf_export.save_cross_encoder_dir(ce_sd, cfg, str(tmp_path / "ce"), vocab=vocab,
                                              merges=merges)
    for mod in (jimport, hf_import):
        real = mod.load_cross_encoder_dir
        monkeypatch.setattr(mod, "load_cross_encoder_dir", lambda d, n=None, real=real: (
            lambda c, p, v: (dataclasses.replace(c, dtype="float32", max_seq_length=32), p, v))(
                *real(d, n)))
    results = {}
    for name, cli, extra in (("jax", jir_main, []), ("port", tir_main, ["--device", "cpu"])):
        out = str(tmp_path / f"out_{name}")
        assert cli.main(["--dataset_root", data, "--encoder_preset", "tiny", "--output_root", out,
                         "--baseline_hf_checkpoint", str(tmp_path / "baseline.bin"),
                         "--n_queries", "8", "--use_cross_encoder", "--cross_encoder_dir", ce_dir,
                         "--score_functions", "cos_sim", "dot_score", "--accuracy_at_k", "1", "3",
                         "--precision_recall_at_k", "1", "5", "--mrr_at_k", "10", "--ndcg_at_k",
                         "10", "--map_at_k", "20", *extra]) == 0
        [hashed] = os.listdir(out)
        with open(os.path.join(out, hashed, "ir_eval_set.json")) as f:
            eval_set = json.load(f)
        with open(os.path.join(out, hashed, "results.json")) as f:
            results[name] = (eval_set, json.load(f))
    (jset, jres), (tset, tres) = results["jax"], results["port"]
    assert tset == jset
    plain = sum(len(v) for v in jset["relevant"].values())
    assert plain > 0
    labeled = [d for v in jset["relevant"].values() for d in v if d.startswith("ref")]
    assert 0 < len(labeled) < 8 * len([d for d in jset["corpus"] if d.startswith("ref")])
    for fn in ("cos_sim", "dot_score"):
        for name, value in jres["baseline"]["metrics"][fn].items():
            assert tres["baseline"]["metrics"][fn][name] == pytest.approx(value, abs=1e-6), name


# --------------------------------------------------------------- on a GPU
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_k7_at_the_roberta_large_view(cuda_device, dtype):
    """K7 on (B, S, 1024) activations seen as (B, 16, S, 64) — head stride
    64, sequence stride 1,024 — with padded rows and predict's pad rows,
    against its plain version: f32 1e-4, bf16 2e-2 of the largest value."""
    from qst_tpu_torch.ops import flash_attention as tfa

    gen = torch.Generator().manual_seed(30)
    B, S, nh, hd = 8, 128, 16, 64
    q, k, v = (torch.randn((B, S, nh * hd), generator=gen).to(cuda_device, dtype)
               .reshape(B, S, nh, hd).transpose(1, 2) for _ in range(3))
    lens = torch.tensor([128, 100, 37, 1, 128, 64, 5, 90])
    seg = (torch.arange(S)[None] < lens[:, None]).to(cuda_device, torch.int32)
    before = tfa.flash_attention.launches
    o = tfa.flash_attention(q, k, v, seg, seg, hd ** -0.5)
    assert tfa.flash_attention.launches == before + 1
    ref = tfa.flash_attention_plain(q, k, v, seg, seg, hd ** -0.5).float()
    tol = 1e-4 if dtype == torch.float32 else 2e-2 * ref.abs().max().item()
    assert (o.float() - ref).abs().max().item() <= tol


@pytest.mark.cuda
def test_cuda_cross_encoder_through_k7_matches_einsum(cuda_device):
    """A RoBERTa cross-encoder (16 heads of 16, f32) at S = 128 with
    ``use_flash_attention``: one K7 launch a layer, logits within 1e-4 of
    the einsum path's."""
    from qst_tpu_torch.ops import flash_attention as tfa

    _, cfg = _cfgs(300, hidden_size=256, num_heads=16, intermediate_size=512,
                   max_position_embeddings=160, max_seq_length=128)
    sd = tce.init_cross_encoder(cfg, torch.Generator().manual_seed(31), device=cuda_device)
    ids, mask, types = (torch.from_numpy(a).long().to(cuda_device)
                        for a in _padded(np.random.default_rng(32), 6, 128, 300))
    out = {}
    for flash in (False, True):
        model = tce.CrossEncoderModule(dataclasses.replace(cfg, use_flash_attention=flash))
        model.load_state_dict(sd)
        before = tfa.flash_attention.launches
        with torch.no_grad():
            out[flash] = model.to(cuda_device).eval()(ids, mask, types)
        assert tfa.flash_attention.launches - before == (cfg.num_layers if flash else 0)
    torch.testing.assert_close(out[True], out[False], rtol=0, atol=1e-4)


def test_fused_layer_flag_with_roberta_routes_as_jax(roberta, bpe_dir):
    """RoBERTa stays on the nn.Module path: with ``use_fused_layer`` the
    encoder takes the module path in both packages (qst_tpu's ``embed_fn``
    routes only bert/mpnet to the fused layer) and the train step's fused
    forward raises, as ``fused_layer_pallas.py:713-715`` does."""
    from qst_tpu.train.train_step import encoder_apply_fn as jax_apply_fn

    jcfg, cfg, params, sd = roberta
    path = bpe_dir[0]
    jf, tf = (dataclasses.replace(c, use_fused_layer=True) for c in (jcfg, cfg))
    want = JaxSentenceEncoder(jf, params, JaxBPE.from_files(path)).encode(DOCS[:4])
    got = SentenceEncoder(tf, sd, RobertaBPETokenizer.from_files(path), device="cpu").encode(
        DOCS[:4])
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    ids, mask, _ = _padded(np.random.default_rng(9), 4, 24, cfg.vocab_size)
    with pytest.raises(ValueError, match="fused layer supports"):
        jax_apply_fn(jf)(params, jnp.asarray(ids), jnp.asarray(mask), None)
    with pytest.raises(ValueError, match="fused layer supports"):
        tts.encoder_apply_fn(tf)(_module(SentenceEncoderModule, tf, sd),
                                 torch.from_numpy(ids).long(), torch.from_numpy(mask).long(),
                                 None)
