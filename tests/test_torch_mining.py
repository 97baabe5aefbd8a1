"""The port's negative mining (``qst_tpu_torch/data/mining.py``) and the
mined dataset path against qst_tpu's, on the CPU.

Hard-contrastive mining is held to qst_tpu's output exactly: the candidate
sub-pools and ``replicate_short`` draw from the same numpy ``Generator``,
and the selection breaks ties toward the lower index as ``jax.lax.top_k``
does. Random mode draws its keys from a ``torch.Generator`` where qst_tpu
draws Gumbel noise, so it is held to its definition instead: only valid
candidates, uniform over them (a chi-square test on a fixed seed), short
rows replicated. The embeddings are the tiny-preset encoder's, with
qst_tpu's weights carried over, or the hash embedder of ``helpers.py``.
"""

import ast
import dataclasses
import inspect
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from helpers import hash_embed, write_synthetic_dataset
from qst_tpu.core import config as jc
from qst_tpu.data import mining as jmining
from qst_tpu.data.quadruplet_dataset import QuadrupletDataset as JaxDataset
from qst_tpu.models.sentence_encoder import SentenceEncoder as JaxSentenceEncoder
from qst_tpu.models.sentence_encoder import init_params as jax_init_params
from qst_tpu.models.tokenizer import HashTokenizer as JaxHashTokenizer
from qst_tpu_torch.core import config as tc
from qst_tpu_torch.data import mining as tmining
from qst_tpu_torch.data.chunks import ChunkStore
from qst_tpu_torch.data.quadruplet_dataset import QuadrupletDataset
from qst_tpu_torch.models.hf_import import state_dict_from_flax_params
from qst_tpu_torch.models.sentence_encoder import SentenceEncoder
from qst_tpu_torch.models.tokenizer import HashTokenizer


def _hash(texts):
    return hash_embed(list(texts))


def _unit_rows(n, d, seed):
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_replicate_short_is_the_source_code():
    def body(fn):
        code = ast.parse(textwrap.dedent(inspect.getsource(fn))).body[0].body[1:]
        return [ast.dump(node) for node in code]          # the docstring aside
    assert body(tmining.replicate_short) == body(jmining.replicate_short)
    idx = np.arange(12).reshape(3, 4)
    ok = np.array([[1, 0, 1, 0], [1, 1, 1, 1], [0, 0, 0, 0]], bool)
    np.testing.assert_array_equal(
        tmining.replicate_short(idx, ok, np.random.default_rng(2)),
        jmining.replicate_short(idx, ok, np.random.default_rng(2)))


@pytest.mark.parametrize("threshold", [0.2, 0.0, -0.15, -1.0])
@pytest.mark.parametrize("n_neg", [1, 4, 300])
def test_hard_mine_negatives_equals_jax(threshold, n_neg):
    """Every validity pattern, from all valid to none (all -inf: the lower
    indices first, as lax.top_k), and a pool smaller than n_neg (padding)."""
    a, t = _unit_rows(16, 32, 1), _unit_rows(200, 32, 2)
    forbidden = np.random.default_rng(3).random((16, 200)) < 0.1
    for forb in (None, forbidden):
        j_idx, j_ok = jmining.mine_negatives(
            jnp.asarray(a), jnp.asarray(t), jax.random.key(0), n_neg, True, threshold,
            None if forb is None else jnp.asarray(forb))
        t_idx, t_ok = tmining.mine_negatives(
            torch.from_numpy(a), torch.from_numpy(t), None, n_neg, True, threshold,
            None if forb is None else torch.from_numpy(forb))
        np.testing.assert_array_equal(t_ok.numpy(), np.asarray(j_ok))
        np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))


def test_random_mine_negatives_picks_only_valid_and_is_uniform():
    a, t = _unit_rows(4, 16, 5), _unit_rows(40, 16, 6)
    cos = a @ t.T
    valid = cos <= 0.1
    counts = np.zeros_like(cos)
    draws = 3000
    for i in range(draws // 3):
        gen = torch.Generator().manual_seed(i)
        idx, ok = tmining.mine_negatives(torch.from_numpy(a), torch.from_numpy(t), gen, 3,
                                         False, threshold=0.1)
        idx, ok = idx.numpy(), ok.numpy()
        assert ok.all()
        for row in range(4):
            assert len(set(idx[row])) == 3 and valid[row, idx[row]].all()
            counts[row, idx[row]] += 1
    for row in range(4):
        seen = counts[row, valid[row]]
        # each valid candidate is picked draws / n_valid times on average
        assert stats.chisquare(seen).pvalue > 1e-3, seen
        assert counts[row, ~valid[row]].sum() == 0


def test_random_mode_replicates_when_short():
    anchors = ["a cat sits on the mat"]
    table_texts = ["the cat rests on a mat", "a dog runs in the park"]   # one valid
    table = tmining.EmbeddingTable(table_texts, _hash, device="cpu")
    miner = tmining.NegativeMiner(table, _hash, mode=tmining.RANDOM)
    negs = miner.mine(anchors, n_neg=3)
    assert negs == [["a dog runs in the park"] * 3]
    jt = jmining.EmbeddingTable(table_texts, _hash)
    assert jmining.NegativeMiner(jt, _hash, mode=jmining.RANDOM).mine(anchors, 3) == negs


def _pair_of_miners(captions, encode_j, encode_t, **kw):
    jt = jmining.EmbeddingTable(captions, encode_j)
    tt = tmining.EmbeddingTable(captions, encode_t, device="cpu")
    return (jmining.NegativeMiner(jt, encode_j, **kw),
            tmining.NegativeMiner(tt, encode_t, **kw))


@pytest.mark.parametrize("mode", [1, 0])
@pytest.mark.parametrize("max_attempts,pool_factor", [(1, 5), (3, 5), (8, 1)])
def test_negative_miner_hard_mode_equals_jax(mode, max_attempts, pool_factor):
    """Hash-embedded topic captions, where most candidates share the
    anchor's topic (invalid): retries and replication both happen."""
    captions = [f"a cat sits on the mat {i}" for i in range(30)] + [
        "a dog runs in the park", "a plate of pasta with sauce", "a plane soaring in the sky"]
    anchors = [f"a cat on a mat number {i}" for i in range(6)] + ["a dog chasing a ball"]
    jm, tm = _pair_of_miners(captions, _hash, _hash, mode=mode, max_attempts=max_attempts,
                             pool_factor=pool_factor, seed=7)
    for step in range(4):
        assert tm.mine(anchors, n_neg=2, step=step) == jm.mine(anchors, n_neg=2, step=step)
    assert tm._calls == jm._calls


def test_negative_miner_hard_mode_equals_jax_on_the_encoders():
    """The tiny encoder's embeddings (qst_tpu's weights in both packages):
    the same negatives, ties aside (embeddings agree to 1e-5)."""
    jcfg = jc.EncoderConfig.tiny()
    params = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.key(8)))
    tcfg = tc.EncoderConfig(**dataclasses.asdict(jcfg))
    jenc = JaxSentenceEncoder(jcfg, params, JaxHashTokenizer(jcfg.vocab_size))
    tenc = SentenceEncoder(tcfg, state_dict_from_flax_params(params, tcfg),
                           HashTokenizer(tcfg.vocab_size))
    rng = np.random.default_rng(4)
    words = [f"w{i}" for i in range(200)]
    captions = [" ".join(rng.choice(words, 8)) for _ in range(120)]
    anchors = [" ".join(rng.choice(words, 8)) for _ in range(10)]
    jm, tm = _pair_of_miners(captions, lambda ts: jenc.encode(list(ts)), tenc.encode,
                             mode=1, threshold=0.95, seed=3)
    ja, ta = jenc.encode(anchors), tenc.encode(anchors)
    jt, tt = jm.table.embeddings, tm.table.embeddings
    assert isinstance(tt, torch.Tensor)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)
    cos = (ta / np.linalg.norm(ta, axis=1, keepdims=True)) @ tt.numpy().T
    got, want = tm.mine(anchors, 3), jm.mine(anchors, 3)
    index = {c: i for i, c in enumerate(captions)}
    for row, (g, w) in enumerate(zip(got, want)):
        for cg, cw in zip(g, w):
            assert cg == cw or abs(cos[row, index[cg]] - cos[row, index[cw]]) < 1e-5


def test_mined_sample_batch_equals_jax(tmp_path):
    root = str(tmp_path / "chunks")
    write_synthetic_dataset(root, n_chunks=3, chunk_dim=8)
    pool = ChunkStore(root).all_positive_captions()
    jm, tm = _pair_of_miners(pool, _hash, _hash, mode=1, seed=14)
    jds = JaxDataset(root, n_pos=2, n_neg=2, miner=jm, seed=5)
    tds = QuadrupletDataset(root, n_pos=2, n_neg=2, miner=tm, seed=5)
    for step, idx in ((0, [0, 3, 5, 7]), (1, [1, 2, 23, 9]), (None, [4, 6, 8, 10])):
        assert tds.sample_batch(idx, step=step) == jds.sample_batch(idx, step=step)
    assert [b for b in tds.iter_batches(8, epoch=1)] == [b for b in jds.iter_batches(8, epoch=1)]
    for item in tds[[0, 1, 2]]:
        a = hash_embed([item["reference"]])
        assert np.all((a @ hash_embed(item["negative"]).T)[0] <= 0.2 + 1e-5)


def test_from_config_mines_like_jax(tmp_path):
    root = str(tmp_path / "chunks")
    write_synthetic_dataset(root, n_chunks=2, chunk_dim=8)
    kw = dict(root=root, n_pos=2, n_neg=2, hard_contrastive_mode=1, neg_sim_threshold=0.2,
              mining_refresh_steps=2, seed=3)
    jds = JaxDataset.from_config(jc.DataConfig(**kw), encode_fn=_hash)
    tds = QuadrupletDataset.from_config(tc.DataConfig(**kw), encode_fn=_hash)
    tds.miner.table.device = "cpu"
    for step in range(5):    # refreshes at steps 0, 2 and 4
        assert tds.sample_batch([step, 7], step=step) == jds.sample_batch([step, 7], step=step)
    assert tds.miner.table._last_refresh == jds.miner.table._last_refresh == 4


def test_embedding_table_caps_the_pool_like_jax():
    caps = [f"c{i}" for i in range(50)]
    jt = jmining.EmbeddingTable(caps, _hash, max_pool=20, rng=np.random.default_rng(1))
    tt = tmining.EmbeddingTable(caps, _hash, max_pool=20, rng=np.random.default_rng(1),
                                device="cpu")
    assert tt.captions == jt.captions and len(tt.captions) == 20
    assert tt.lookup(np.array([[0, 3]])) == jt.lookup(np.array([[0, 3]]))
    with pytest.raises(ValueError):
        tmining.EmbeddingTable([], _hash)
    with pytest.raises(ValueError):
        tmining.NegativeMiner(tt, _hash, pool_factor=0)
