"""The ported serving slice against qst_tpu, end to end: ``ExactIndex``
search for every storage dtype and score, ``Retriever`` persistence across
the two packages, and ``Retriever`` + ``RetrievalServer`` answering
``/search`` and ``/encode`` with qst_tpu's rows.

Tolerances: index searches over the same embeddings compare scores with
rtol 1e-6 (atol 1e-6 near zero) and ids up to ties — ``lax.top_k`` and
``torch.topk`` order equal scores differently. The served slice encodes
with each package's own encoder, whose embeddings agree within 1e-5, so its
scores compare at atol 1e-5.
"""

import dataclasses
import json
import urllib.request

import jax
import numpy as np
import pytest
import torch

from qst_tpu.core.config import EncoderConfig as JaxConfig
from qst_tpu.models.sentence_encoder import SentenceEncoder as JaxSentenceEncoder
from qst_tpu.models.sentence_encoder import init_params as jax_init_params
from qst_tpu.models.tokenizer import HashTokenizer as JaxHashTokenizer
from qst_tpu.retrieval import Retriever as JaxRetriever
from qst_tpu.retrieval.index import ExactIndex as JaxExactIndex
from qst_tpu.retrieval.retriever import load_index as jax_load_index
from qst_tpu_torch.core.config import EncoderConfig
from qst_tpu_torch.models.hf_import import state_dict_from_flax_params
from qst_tpu_torch.models.sentence_encoder import SentenceEncoder
from qst_tpu_torch.models.tokenizer import HashTokenizer
from qst_tpu_torch.retrieval import ExactIndex, Retriever, load_index
from qst_tpu_torch.serve import RetrievalServer


def assert_topk_equal_up_to_ties(s_a, i_a, s_b, i_b, rtol=1e-6, atol=1e-6):
    """Scores agree within tolerance row by row; ids agree except where
    equal scores let the two top-k orders (or the k-th slot) differ."""
    s_a, s_b = np.asarray(s_a, np.float64), np.asarray(s_b, np.float64)
    np.testing.assert_allclose(s_a, s_b, rtol=rtol, atol=atol)
    for row in range(s_a.shape[0]):
        tie = rtol * np.abs(s_a[row]).max() + atol
        kth = min(s_a[row, -1], s_b[row, -1])
        sure_a = {i for i, s in zip(i_a[row], s_a[row]) if s > kth + tie}
        sure_b = {i for i, s in zip(i_b[row], s_b[row]) if s > kth + tie}
        assert sure_a <= set(i_b[row]) and sure_b <= set(i_a[row]), row


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((6000, 32)).astype(np.float32)
    emb[100] = emb[7]                  # an exact tie
    queries = rng.standard_normal((7, 32)).astype(np.float32)
    queries[0] = emb[7]
    return emb, queries


CASES = [(d, s) for d in ("float32", "bfloat16") for s in ("cos_sim", "dot_score", "euclid_score")
         ] + [("int8", "cos_sim"), ("int8", "dot_score")]


@pytest.mark.parametrize("dtype,score", CASES)
def test_exact_index_search_matches_jax(corpus, dtype, score):
    emb, queries = corpus
    jidx = JaxExactIndex(emb, dtype=dtype)
    tidx = ExactIndex(torch.from_numpy(emb), dtype=dtype)
    if dtype == "int8":
        np.testing.assert_array_equal(tidx.embeddings.numpy(), np.asarray(jidx.embeddings))
        assert tidx._int8_scale == jidx._int8_scale
    js, ji = jidx.search(queries, k=10, score=score, tile=2048)
    backends = ("xla", "pallas") if score != "euclid_score" else ("xla",)
    for backend in backends:   # on a CPU index "pallas" runs the kernels' plain versions
        ts, ti = tidx.search(queries, k=10, score=score, tile=2048, backend=backend)
        assert ts.shape == ti.shape == (7, 10)
        assert_topk_equal_up_to_ties(ts, ti, js, ji)


def test_exact_index_search_ids_stream_and_errors(corpus):
    emb, queries = corpus
    ids = [f"doc{i}" for i in range(len(emb))]
    idx = ExactIndex(emb, ids=ids, dtype="bfloat16", device="cpu")
    s, names = idx.search_ids(queries, k=3)
    assert names[0][0] in ("doc7", "doc100")
    batches = [queries[:3], queries[3:]]
    streamed = list(idx.search_stream(batches, k=4, depth=2))
    for b, (ss, ii) in zip(batches, streamed):
        s1, i1 = idx.search(b, k=4)
        np.testing.assert_array_equal(ss, s1)
        np.testing.assert_array_equal(ii, i1)
    with pytest.raises(NotImplementedError):
        ExactIndex(emb, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        idx.search(queries, backend="tpu")
    with pytest.raises(ValueError):
        ExactIndex(emb, dtype="int8", device="cpu").search(queries, score="euclid_score")


@pytest.fixture(scope="module")
def stacks():
    jcfg = JaxConfig.tiny()
    params = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.key(21)))
    cfg = EncoderConfig(**dataclasses.asdict(jcfg))
    jenc = JaxSentenceEncoder(jcfg, params, JaxHashTokenizer(jcfg.vocab_size))
    tenc = SentenceEncoder(cfg, state_dict_from_flax_params(params, cfg),
                           HashTokenizer(jcfg.vocab_size))
    rng = np.random.default_rng(3)
    words = [f"w{i}" for i in range(60)]
    docs = [" ".join(rng.choice(words, rng.integers(3, 12))) for _ in range(150)]
    return jenc, tenc, docs


QUERIES = ["w1 w2 w3", "w59 w10", "w7 w7 w7 w8 w30 w31", "unseen words here"]


def _post(port, path, obj):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("index_dtype", ["float32", "bfloat16"])
def test_server_answers_like_jax_retriever(stacks, index_dtype):
    jenc, tenc, docs = stacks
    jr = JaxRetriever(jenc, index_dtype=index_dtype).build(docs)
    tr = Retriever(tenc, index_dtype=index_dtype).build(docs)
    want = jr.search(QUERIES, k=5, return_texts=True)
    server = RetrievalServer(tr, port=0, max_wait_s=0.01)
    port = server.start()
    try:
        got = _post(port, "/search", {"queries": QUERIES, "k": 5, "return_texts": True})
        emb = _post(port, "/encode", {"texts": QUERIES[:2]})["embeddings"]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
            assert json.loads(r.read()) == {"ok": True, "n_docs": len(docs)}
    finally:
        server.stop()
    rows = got["results"]
    assert_topk_equal_up_to_ties([[r[1] for r in row] for row in rows],
                                 [[r[0] for r in row] for row in rows],
                                 [[r[1] for r in row] for row in want],
                                 [[r[0] for r in row] for row in want], rtol=0, atol=1e-5)
    for row in rows:
        assert all(docs[doc_id] == text for doc_id, _, text in row)
    np.testing.assert_allclose(emb, jenc.encode(QUERIES[:2]), rtol=0, atol=1e-5)


def test_retriever_paths_agree_and_persist_across_packages(stacks, tmp_path):
    jenc, tenc, docs = stacks
    tr = Retriever(tenc, index_dtype="int8").build(docs, ids=[f"d{i}" for i in range(len(docs))])
    rows = tr.search(QUERIES, k=4)
    assert tr.search_async(QUERIES, k=4)() == rows
    # int8 queries quantize under one scale per batch, so compare batch for batch
    assert list(tr.search_stream([QUERIES, QUERIES[:2]], k=4)) == [
        rows, tr.search(QUERIES[:2], k=4)]
    tr.save(str(tmp_path / "idx"))
    jidx, meta = jax_load_index(str(tmp_path / "idx"))   # qst_tpu reads the port's artifact
    assert meta["dtype"] == "int8" and jidx._int8_scale == tr.index._int8_scale
    np.testing.assert_array_equal(np.asarray(jidx.embeddings), tr.index.embeddings.numpy())
    again = Retriever(tenc, index_dtype="int8").load(str(tmp_path / "idx"))
    assert again.search(QUERIES, k=4) == rows
    JaxRetriever(jenc, index_dtype="bfloat16").build(docs).save(str(tmp_path / "jidx"))
    tidx, meta = load_index(str(tmp_path / "jidx"), device="cpu")      # and the other way round
    assert tidx.embeddings.dtype == torch.bfloat16 and tidx.n_docs == len(docs)


def test_unported_retriever_options_raise(stacks):
    _, tenc, _ = stacks
    with pytest.raises(NotImplementedError):
        Retriever(tenc, mesh=object())
