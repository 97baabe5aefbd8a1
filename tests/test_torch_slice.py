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
from qst_tpu_torch.core.meshes import batch_sharding, make_mesh, single_device_mesh
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
    with pytest.raises(TypeError, match="Mesh"):
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
    """A mesh that is not the port's is refused (a JAX mesh included)."""
    _, tenc, _ = stacks
    with pytest.raises(TypeError, match="Mesh"):
        Retriever(tenc, mesh=object())


@pytest.fixture(scope="module")
def tmesh():
    return make_mesh(4, 2, devices=["cpu"] * 8)


@pytest.mark.parametrize("kind", ["float32", "int8", "ivf", "pq", "ivfpq", "streaming"])
def test_sharded_retriever_journey(stacks, tmesh, mesh8, tmp_path, kind):
    """``Retriever(mesh=)`` over eight CPU positions: build (or build to
    disk), search, save, and reload sharded — the answers the unsharded
    Retriever's from the same encoder and seed (up to ties), the artifact
    free of the mesh's padding and readable by qst_tpu, and for the exact
    kinds qst_tpu's ``Retriever(mesh=mesh8)``'s answers."""
    jenc, tenc, docs = stacks
    if kind in ("pq", "ivfpq"):     # the codebooks train on >= 256 docs
        docs = docs + [f"{d} w{i % 60}" for i, d in enumerate(docs)]
    kw = dict(index_dtype=kind, ivf_clusters=4, ivf_probe=4, pq_m=8)
    ids = [f"d{i}" for i in range(len(docs))]
    made = {}
    for name, mesh in (("sharded", tmesh), ("plain", None)):
        r = Retriever(tenc, mesh=mesh, **kw)
        if kind == "streaming":
            r.build_to_disk(docs, str(tmp_path / f"{name}_disk"), ids=ids)
        else:
            r.build(docs, ids=ids)
        made[name] = r
    assert made["sharded"].index.mesh is tmesh and made["plain"].index.mesh is None

    def answers(r):
        rows = r.search(QUERIES, k=5)
        return ([[x[1] for x in row] for row in rows],
                [[ids.index(x[0]) for x in row] for row in rows])

    want = answers(made["plain"])
    assert_topk_equal_up_to_ties(*answers(made["sharded"]), *want, rtol=1e-6, atol=1e-6)
    made["sharded"].save(str(tmp_path / "idx"))
    with open(tmp_path / "idx" / "ids.json") as f:
        assert json.load(f) == ids
    if kind in ("float32", "int8", "streaming"):
        assert np.load(tmp_path / "idx" / "embeddings.npy").shape[0] == len(docs)
        jidx, _ = jax_load_index(str(tmp_path / "idx"))
        assert jidx.n_docs == len(docs)
    if kind in ("ivf", "ivfpq"):
        fill = np.load(tmp_path / "idx" / f"{kind}_fill.npy")
        cells = np.load(tmp_path / "idx" / f"{kind}_{'cells' if kind == 'ivf' else 'cell_codes'}.npy")
        assert cells.shape[0] == fill.shape[0] == 4      # no padded cell saved
    again = Retriever(tenc, mesh=tmesh, **kw).load(str(tmp_path / "idx"))
    assert again.index.mesh is tmesh
    assert_topk_equal_up_to_ties(*answers(again), *want, rtol=1e-6, atol=1e-6)
    if kind in ("float32", "int8"):
        jr = JaxRetriever(jenc, mesh=mesh8, index_dtype=kind).build(docs, ids=ids)
        assert_topk_equal_up_to_ties(*answers(made["sharded"]), *answers(jr),
                                     rtol=0, atol=1e-5)


def test_an_encoder_on_a_mesh_runs_on_the_mesh_device_even_with_one_position():
    """``SentenceEncoder(mesh=)`` without ``device`` takes the mesh's first
    device, a one-position mesh's too (which runs the unsharded path), as
    ``ExactIndex(mesh=)`` does; without a mesh, the params' device. (A
    1 x 1 mesh of the card with a checkpoint loaded on the CPU encoded on
    the CPU.) The meta device stands in for a card here."""
    import warnings

    from qst_tpu_torch.models.sentence_encoder import init_params

    cfg = EncoderConfig.tiny()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tok = HashTokenizer(cfg.vocab_size)
    assert SentenceEncoder(cfg, params, tok).device == torch.device("cpu")
    with warnings.catch_warnings():      # loading CPU tensors into meta ones copies nothing
        warnings.simplefilter("ignore")
        for mesh in (make_mesh(1, 1, devices=["meta"]), single_device_mesh("meta")):
            enc = SentenceEncoder(cfg, params, tok, mesh=mesh)
            assert enc.mesh is None and enc.device == torch.device("meta")
            assert next(enc.model.parameters()).device == torch.device("meta")
    index = ExactIndex(torch.randn(4, 8), mesh=make_mesh(1, 1, devices=["meta"]))
    assert index.mesh is None and index.device == torch.device("meta")


def test_sharded_sentence_encoder_matches_jax(stacks, tmesh, mesh8):
    """``SentenceEncoder(mesh=, out_sharding=)``, after
    tests/test_parallel.py:123-160: batches rounded up to the data axis and
    split over it give the unsharded encode's embeddings bit for bit, and
    qst_tpu's sharded encode's within 1e-5 (70 texts: a ragged last batch;
    the port takes and ignores ``pipeline_batches``)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from qst_tpu.core.meshes import DATA_AXIS

    jenc, tenc, _ = stacks
    texts = [f"sentence {i} topic {i % 7}" for i in range(70)]
    jsh = JaxSentenceEncoder(jenc.cfg, jenc.params, jenc.tokenizer, mesh=mesh8,
                             out_sharding=NamedSharding(mesh8, P(DATA_AXIS)))
    want = jsh.encode(texts, batch_size=32)
    params = tenc.model.state_dict()
    plain = tenc.encode(texts, batch_size=32)
    for out in (None, batch_sharding(tmesh)):
        enc = SentenceEncoder(tenc.cfg, params, tenc.tokenizer, mesh=tmesh, out_sharding=out)
        got = enc.encode(texts, batch_size=32, pipeline_batches=3)
        np.testing.assert_array_equal(got, plain)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        dev = enc.encode(texts[:5], convert_to_numpy=False)
        assert dev.shape == (5, tenc.cfg.hidden_size) and dev.device == torch.device("cpu")
    # one position, or a data axis of one: the unsharded path, as in qst_tpu
    for one in (single_device_mesh("cpu"), make_mesh(1, 8, devices=["cpu"] * 8)):
        enc = SentenceEncoder(tenc.cfg, params, tenc.tokenizer, mesh=one)
        assert enc._n_data == 1 and (enc.mesh is None) == (one.size == 1)
        np.testing.assert_array_equal(enc.encode(texts, batch_size=32), plain)
    with pytest.raises(TypeError, match="out_sharding"):
        SentenceEncoder(tenc.cfg, params, tenc.tokenizer, out_sharding=object())
