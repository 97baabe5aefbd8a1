"""The port's MLM head (``models/mlm.py``) and ``MLMAugmenter``
(``augment/mlm.py``) against qst_tpu's.

- ``BertMLMModule`` logits through ``mlm_logits_fn`` against JAX's, BERT
  and RoBERTa trunks, 1e-5 at f32, on JAX ``init_mlm_params`` weights
  carried over by ``state_dict_from_flax_params``;
- the augmenter's mask-slot logits (only those rows are projected onto
  the vocabulary) against the rows of the full (B, S, V) logits, 1e-5;
- ``MLMAugmenter.augment`` for both actions equal to JAX's when both are
  fed the same logits (the numpy draws are the source's, in its order), and
  equal to JAX's over the two packages' own forwards;
- the source's argument checks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qst_tpu.augment.mlm import MLMAugmenter as JaxMLMAugmenter
from qst_tpu.core import config as jc
from qst_tpu.models import mlm as jmlm
from qst_tpu.models.tokenizer import WordPieceTokenizer as JaxWordPiece
from qst_tpu_torch.augment import MLMAugmenter
from qst_tpu_torch.core import config as tc
from qst_tpu_torch.models import mlm as tmlm
from qst_tpu_torch.models.hf_import import state_dict_from_flax_params
from qst_tpu_torch.models.tokenizer import WordPieceTokenizer

ATOL = 1e-5
WORDS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "the", "cat", "dog", "car", "red",
         "sits", "runs", "on", "in", "mat", "park", "road", "of", "pasta", "beach", "plane",
         "sky", "people", "sand", "young", "small", "with", "sauce", "play", "##s", "##ing",
         "##ed", "blue", "green", "house", "tree", "river", "bird", "fly"]
VOCAB = {w: i for i, w in enumerate(WORDS)}
TEXTS = ["a red car on the road", "the cat sits on a mat", "people playing in the park",
         "pasta with red sauce", "a small plane in the sky", "dogs run on the sand",
         "a bird flying over the river", "the young dog plays with a blue car", "tree",
         "the green house by the river with a red tree and a small bird"]


def _cfgs(arch="bert"):
    base = dict(name=f"mlm-{arch}", arch=arch, vocab_size=len(WORDS) + 24, hidden_size=32,
                num_layers=2, num_heads=4, intermediate_size=64, max_position_embeddings=40,
                max_seq_length=12, dtype="float32")
    if arch == "roberta":
        base.update(type_vocab_size=1, layer_norm_eps=1e-5, pad_token_id=1)
    jcfg = jc.EncoderConfig(**base)
    return jcfg, tc.EncoderConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def mlm():
    jcfg, cfg = _cfgs()
    params = jax.tree.map(np.asarray, jmlm.init_mlm_params(jcfg, jax.random.key(2)))
    return jcfg, cfg, params, state_dict_from_flax_params(params, cfg)


def _ids(cfg, B=4, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, cfg.vocab_size, (B, cfg.max_seq_length)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 7:] = 0
    ids[mask == 0] = cfg.pad_token_id
    return ids, mask


@pytest.mark.parametrize("arch", ["bert", "roberta"])
def test_logits_match_jax(arch):
    jcfg, cfg = _cfgs(arch)
    params = jax.tree.map(np.asarray, jmlm.init_mlm_params(jcfg, jax.random.key(3)))
    sd = state_dict_from_flax_params(params, cfg)
    assert set(sd) == set(tmlm.BertMLMModule(cfg).state_dict())
    ids, mask = _ids(cfg)
    want = np.asarray(jmlm.mlm_logits_fn(jcfg)(params, jnp.asarray(ids), jnp.asarray(mask)))
    got = tmlm.mlm_logits_fn(cfg)(sd, ids, mask)
    assert got.shape == (4, cfg.max_seq_length, cfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_init_mlm_params_draws_the_flax_layout():
    _, cfg = _cfgs()
    sd = tmlm.init_mlm_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert set(sd) == set(tmlm.BertMLMModule(cfg).state_dict())
    assert torch.equal(sd["transform_layer_norm.weight"], torch.ones(cfg.hidden_size))
    assert not sd["decoder.bias"].any() and sd["decoder.weight"].shape == (cfg.vocab_size, 32)


def _augmenters(mlm, action, **kw):
    jcfg, cfg, params, sd = mlm
    return (JaxMLMAugmenter(jcfg, params, JaxWordPiece(VOCAB), action=action, **kw),
            MLMAugmenter(cfg, sd, WordPieceTokenizer(VOCAB), action=action, **kw))


def test_slot_logits_are_rows_of_the_full_logits(mlm):
    _, cfg, _, sd = mlm
    _, aug = _augmenters(mlm, "substitute")
    ids, mask = _ids(cfg, seed=1)
    rows, slots = np.array([0, 0, 2, 3, 1]), np.array([1, 5, 0, 11, 6])
    full = tmlm.mlm_logits_fn(cfg)(sd, ids, mask).numpy()
    np.testing.assert_allclose(aug._slot_logits(ids, mask, rows, slots), full[rows, slots],
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("action", ["substitute", "insert"])
@pytest.mark.parametrize("aug", [(1, 2), (0, 3), (2, 2)], ids=["1-2", "0-3", "2-2"])
def test_augment_equals_jax_given_the_same_logits(mlm, action, aug):
    """Both augmenters read one (N, S, V) logits array (JAX's through its
    forward, the port's through the mask-slot rows): the same texts, call
    after call."""
    j, t = _augmenters(mlm, action, aug_min=aug[0], aug_max=aug[1], top_k=5, seed=9)
    _, cfg, _, _ = mlm
    for call in range(3):
        texts = TEXTS[call:] + TEXTS[:call]
        logits = np.random.default_rng(call).standard_normal(
            (len(texts), cfg.max_seq_length, cfg.vocab_size)).astype(np.float32)
        j._fwd = lambda p, i, m, logits=logits: jnp.asarray(logits)
        t._slot_logits = lambda i, m, rows, slots, logits=logits: logits[rows, slots]
        assert t.augment(texts) == j.augment(texts)
    assert t.augment("one text") == j.augment("one text")


@pytest.mark.parametrize("action", ["substitute", "insert"])
def test_augment_equals_jax_through_both_forwards(mlm, action):
    j, t = _augmenters(mlm, action, seed=4)
    out = t.augment(TEXTS)
    assert out == j.augment(TEXTS)
    assert out != TEXTS and all(isinstance(o, str) for o in out)


def test_bad_arguments_raise_as_the_source(mlm):
    for kw in (dict(action="delete"), dict(aug_min=-1), dict(aug_min=3, aug_max=2)):
        for cls in (JaxMLMAugmenter, MLMAugmenter):
            cfg, params = (mlm[0], mlm[2]) if cls is JaxMLMAugmenter else (mlm[1], mlm[3])
            with pytest.raises(ValueError):
                cls(cfg, params, WordPieceTokenizer(VOCAB), **kw)
