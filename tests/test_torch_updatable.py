"""The port's ``UpdatableIndex``, the ``Retriever``'s IVF and updatable
paths and the server's ``POST/DELETE /docs`` against qst_tpu.

Both packages get the same rows (numpy, from a seed, or the tests' hash
encoder). Scores compare at rtol 1e-5 / atol 1e-6 (the same products, f32
sums in another order) and ids up to ties. IVF artifacts cross the packages
both ways; a port-built IVF index is not the JAX build (its k-means init
comes from a ``torch.Generator``), so IVF answers are compared on one saved
index loaded by both.
"""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from helpers import hash_embed
from qst_tpu.retrieval import Retriever as JaxRetriever
from qst_tpu.retrieval.updatable import UpdatableIndex as JaxUpdatableIndex
from qst_tpu_torch.core.device import device_of, resolve_device
from qst_tpu_torch.retrieval import ExactIndex, IVFIndex, Retriever, UpdatableIndex, load_index
from qst_tpu_torch.retrieval.updatable import _masked_search
from qst_tpu_torch.serve import RetrievalServer

TOL = dict(rtol=1e-5, atol=1e-6)


class MockEncoder:
    """No ``device`` attribute: the Retriever is told where to run."""

    def encode(self, texts):
        return hash_embed(list(texts))


DOCS = [
    "a cat sits on the mat",
    "the cat rests on a mat",
    "a dog runs in the park",
    "pasta with tomato sauce",
    "a plane above the clouds",
]


def _many_docs(n=600):
    topics = ["cat", "dog", "pasta", "plane", "river"]
    return [f"{topics[i % len(topics)]} document number {i}" for i in range(n)]


def _rows_close(got, want):
    assert [[r[0] for r in row] for row in got] == [[r[0] for r in row] for row in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose([r[1] for r in g], [r[1] for r in w], **TOL)
        assert [r[2:] for r in g] == [r[2:] for r in w]


# --------------------------------------------------------- UpdatableIndex
def test_updatable_index_matches_jax_through_adds_and_removes():
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((12, 8)).astype(np.float32)
    queries = rng.standard_normal((5, 8)).astype(np.float32)
    j, t = JaxUpdatableIndex(8, capacity=16), UpdatableIndex(8, capacity=16, device="cpu")
    ids = [f"d{i}" for i in range(12)]

    def same():
        assert t.ids == j.ids and len(t) == len(j) and t.n_docs == j.n_docs
        assert t._state[2] == j._state[2]
        np.testing.assert_allclose(t._buffer.numpy(), np.asarray(j._buffer), rtol=0, atol=1e-6)
        for k in (1, 4, 99):
            (ts, ti), (js, ji) = t.search(queries, k=k), j.search(queries, k=k)
            np.testing.assert_allclose(ts, js, **TOL)
            assert ti == ji

    for idx in (j, t):
        idx.add(rows[:7], ids[:7])
    same()
    for idx in (j, t):
        idx.remove(["d1", "d6", "d3"])       # an inner row, the last row, another
    same()
    for idx in (j, t):
        idx.add(rows[7:], ids[7:])
        idx.remove(["d0"])
        idx.add(rows[:1] * 3, ["d0"])        # a removed id comes back, re-normalized
    same()
    for idx in (j, t):
        idx.remove(list(idx.ids))            # down to empty
    assert len(t) == len(j) == 0
    with pytest.raises(RuntimeError, match="empty"):
        t.search(queries)


def test_updatable_index_errors_match_jax():
    rows = np.eye(8, dtype=np.float32)
    for make in (lambda: JaxUpdatableIndex(8, capacity=4),
                 lambda: UpdatableIndex(8, capacity=4, device="cpu")):
        idx = make()
        idx.add(rows[:2], ["a", "b"])
        with pytest.raises(KeyError, match="already present"):
            idx.add(rows[:1], ["a"])
        with pytest.raises(KeyError, match="duplicate"):
            idx.add(rows[:2], ["c", "c"])
        with pytest.raises(RuntimeError, match="capacity"):
            idx.add(rows[:3], ["c", "d", "e"])
        with pytest.raises(KeyError, match="unknown id"):
            idx.remove(["zzz"])
        with pytest.raises(ValueError, match="embeddings"):
            idx.add(np.zeros((1, 7), np.float32), ["x"])
        with pytest.raises(ValueError, match="ids length"):
            idx.add(rows[:2], ["x"])
        assert idx.ids == ("a", "b")         # a refused update publishes nothing
    with pytest.raises(ValueError, match=">= 1"):
        UpdatableIndex(0, device="cpu")


def test_inflight_snapshot_survives_updates():
    """A search that captured the pre-update state stays valid: updates
    build new buffers and never write into the one a search may hold."""
    idx = UpdatableIndex(dim=8, capacity=32, device="cpu")
    emb = np.eye(8, dtype=np.float32)[:4]
    idx.add(emb, ["a", "b", "c", "d"])
    buffer, ids, _ = idx._state          # in-flight snapshot
    kept = buffer.clone()
    idx.remove(["a"])                    # a concurrent writer publishes
    idx.add(np.eye(8, dtype=np.float32)[4:6], ["e", "f"])
    assert torch.equal(buffer, kept)
    _, i = _masked_search(torch.from_numpy(emb[:1]), buffer, len(ids), 1)
    assert ids[int(i[0, 0])] == "a"
    _, ids2 = idx.search(emb[:1], k=4)
    assert "a" not in ids2[0] and len(idx) == 5


# ------------------------------------------------- Retriever, updatable mode
def test_retriever_updatable_matches_jax(tmp_path):
    j = JaxRetriever(MockEncoder()).build_updatable(DOCS[:3], capacity=64)
    t = Retriever(MockEncoder(), device="cpu").build_updatable(DOCS[:3], capacity=64)
    queries = ["a cat sits on the mat", "pasta with tomato sauce"]
    _rows_close(t.search(queries, k=2, return_texts=True),
                j.search(queries, k=2, return_texts=True))
    assert t.add_docs(DOCS[3:]) == j.add_docs(DOCS[3:]) == [3, 4]
    _rows_close(t.search(queries, k=5), j.search(queries, k=5))
    assert t.search_async(queries, k=2)() == t.search(queries, k=2)
    for r in (j, t):
        r.remove_docs([3])
    got = t.search(queries, k=5, return_texts=True)
    _rows_close(got, j.search(queries, k=5, return_texts=True))
    assert all(doc_id != 3 for doc_id, _, _ in got[1]) and len(got[1]) == 4

    # save() persists a static snapshot either package reloads as an ExactIndex
    t.save(str(tmp_path / "snap"))
    for again in (Retriever(MockEncoder(), device="cpu").load(str(tmp_path / "snap")),
                  JaxRetriever(MockEncoder()).load(str(tmp_path / "snap"))):
        rows = again.search(["a dog runs in the park"], k=1, return_texts=True)
        assert rows[0][0][0] == 2 and rows[0][0][2] == DOCS[2]


def test_retriever_updatable_guards():
    r = Retriever(MockEncoder(), device="cpu")
    with pytest.raises(RuntimeError, match="updatable"):
        r.add_docs(["x"])
    with pytest.raises(RuntimeError, match="updatable"):
        r.remove_docs([0])
    with pytest.raises(RuntimeError, match="no index"):
        r.to_updatable()
    r.build_updatable(DOCS, ids=list("abcde"), capacity=16)
    with pytest.raises(RuntimeError, match="static"):
        list(r.search_stream([["q"]], k=1))
    with pytest.raises(ValueError, match="cos_sim"):
        Retriever(MockEncoder(), score="euclid_score", device="cpu").build_updatable(DOCS)
    # an empty corpus answers with no hits, not an error
    assert Retriever(MockEncoder(), device="cpu").build_updatable(capacity=16).search(
        ["anything"], k=3) == [[]]

    class ScaledEncoder:
        def encode(self, texts):
            return 3.0 * hash_embed(list(texts))

    with pytest.raises(ValueError, match="unit-norm"):
        Retriever(ScaledEncoder(), score="dot_score", device="cpu").build_updatable(DOCS)
    static = Retriever(ScaledEncoder(), score="dot_score", device="cpu").build(DOCS)
    with pytest.raises(ValueError, match="unit-norm"):
        static.to_updatable()


def test_to_updatable_from_exact_index():
    r = Retriever(MockEncoder(), device="cpu").build(DOCS, ids=list("abcde"))
    static_rows = r.search([DOCS[1]], k=3, return_texts=True)
    r.to_updatable()
    assert r._is_updatable() and r.index.capacity >= 2 * len(DOCS)
    _rows_close(r.search([DOCS[1]], k=3, return_texts=True), static_rows)
    r.add_docs(["a brand new document"], ids=["new"])
    assert r.search(["a brand new document"], k=1)[0][0][0] == "new"
    r.to_updatable()                             # idempotent
    assert r.add_docs(["another one"]) == [0]    # the auto-id counter skips non-int ids


# ------------------------------------------------------- Retriever over IVF
@pytest.fixture(scope="module")
def ivf_dirs(tmp_path_factory):
    """One IVF index saved by each package (600 docs, 16 cells, probe 4)."""
    docs = _many_docs()
    ids = [f"d{i}" for i in range(len(docs))]
    root = tmp_path_factory.mktemp("ivf")
    t = Retriever(MockEncoder(), index_dtype="ivf", ivf_clusters=16, ivf_probe=4,
                  device="cpu").build(docs, ids=ids)
    t.save(str(root / "port"))
    j = JaxRetriever(MockEncoder(), index_dtype="ivf", ivf_clusters=16,
                     ivf_probe=4).build(docs, ids=ids)
    j.save(str(root / "jax"))
    return t, j, str(root / "port"), str(root / "jax")


QUERIES = ["a cat rests", "a dog runs", "pasta dish", "a plane flies", "river bank walk"]


def test_retriever_ivf_build_save_load(ivf_dirs):
    t, _, port_dir, _ = ivf_dirs
    assert isinstance(t.index, IVFIndex) and t.index.default_n_probe == 4
    before = t.search(QUERIES, k=5, return_texts=True)
    assert before[0][0][2].startswith("cat")
    assert os.path.isfile(os.path.join(port_dir, "ivf_cells.npy"))
    with open(os.path.join(port_dir, "index_meta.json")) as f:
        meta = json.load(f)
    assert meta == {"n_docs": 600, "dim": 128, "dtype": "ivf", "cells_dtype": "float32",
                    "n_probe": 4, "cell_budget": t.index.cell_budget, "score": "cos_sim"}
    again = Retriever(MockEncoder(), index_dtype="ivf", device="cpu").load(port_dir)
    assert again.index.default_n_probe == 4
    assert again.search(QUERIES, k=5, return_texts=True) == before
    assert again.search_async(QUERIES, k=5, return_texts=True)() == before
    assert list(again.search_stream([QUERIES[:2], QUERIES[2:]], k=5, return_texts=True)) == [
        before[:2], before[2:]]
    with pytest.raises(ValueError, match="IVF"):
        load_index(port_dir, dtype="bfloat16", device="cpu")
    exact = Retriever(MockEncoder(), device="cpu").build(_many_docs()[:50])
    exact.save(port_dir + "_exact")
    with pytest.raises(ValueError, match="not saved as an IVF"):
        load_index(port_dir + "_exact", dtype="ivf", device="cpu")


@pytest.mark.parametrize("saved_by", ["port", "jax"])
def test_ivf_artifact_crosses_the_packages(ivf_dirs, saved_by):
    """A directory written by either package's Retriever.save loads in both,
    with equal answers (the same cells, searched by each package)."""
    _, _, port_dir, jax_dir = ivf_dirs
    path = port_dir if saved_by == "port" else jax_dir
    t = Retriever(MockEncoder(), index_dtype="ivf", device="cpu").load(path)
    j = JaxRetriever(MockEncoder(), index_dtype="ivf").load(path)
    assert t.index.n_docs == j.index.n_docs == 600
    assert t.index.cell_budget == j.index.cell_budget
    assert t.index.default_n_probe == j.index.default_n_probe == 4
    np.testing.assert_array_equal(t.index.cells.numpy(), np.asarray(j.index.cells))
    for k in (5, 300):        # 300 > the 4 probed cells' documents: short rows
        _rows_close(t.search(QUERIES, k=k, return_texts=True),
                    j.search(QUERIES, k=k, return_texts=True))


def test_ivf_bf16_artifact_crosses_the_packages(tmp_path):
    """bf16 cells persist as f32 + ``cells_dtype`` and reload exactly."""
    docs = _many_docs(300)
    emb = hash_embed(docs)
    t = Retriever(MockEncoder(), index_dtype="ivf", device="cpu")
    t.index = IVFIndex(emb, n_clusters=8, dtype="bfloat16", default_n_probe=3, device="cpu")
    t._doc_texts = docs
    t.save(str(tmp_path / "b16"))
    j = JaxRetriever(MockEncoder(), index_dtype="ivf").load(str(tmp_path / "b16"))
    again = Retriever(MockEncoder(), index_dtype="ivf", device="cpu").load(str(tmp_path / "b16"))
    assert again.index.cells.dtype == torch.bfloat16 and str(j.index.cells.dtype) == "bfloat16"
    assert torch.equal(again.index.cells, t.index.cells)
    _rows_close(again.search(QUERIES, k=5), j.search(QUERIES, k=5))


def test_rows_drop_missing_hits_instead_of_the_last_document(ivf_dirs):
    """An IVF search marks "no document" with −1; as a list index that is
    the last document. The rows must drop it."""
    _, _, port_dir, _ = ivf_dirs
    r = Retriever(MockEncoder(), index_dtype="ivf", device="cpu").load(port_dir)
    r.index.default_n_probe = 1
    scores, idx = r.index._device_search_retriever(hash_embed(QUERIES), 256)
    assert (idx < 0).any() and torch.isneginf(scores[idx < 0]).all()
    for row, i in zip(r.search(QUERIES, k=256, return_texts=True), idx):
        assert len(row) == int((i >= 0).sum()) < 256
        assert len({doc_id for doc_id, _, _ in row}) == len(row)
        assert all(np.isfinite(s) for _, s, _ in row)
    assert r.search_async(QUERIES, k=256)() == r.search(QUERIES, k=256)


def test_to_updatable_from_ivf_index(ivf_dirs):
    _, _, port_dir, _ = ivf_dirs
    r = Retriever(MockEncoder(), index_dtype="ivf", device="cpu").load(port_dir)
    r.index.default_n_probe = 16                      # full probe: exact
    static_rows = r.search(QUERIES, k=3, return_texts=True)
    r.to_updatable(capacity=2048)
    assert isinstance(r.index, UpdatableIndex) and r.index.n_docs == 600
    assert r.index.capacity == 2048
    _rows_close(r.search(QUERIES, k=3, return_texts=True), static_rows)
    assert r.add_docs(["zebra stripes in sunlight"], ids=["zebra"]) == ["zebra"]
    assert r.search(["zebra stripes in sunlight"], k=1)[0][0][0] == "zebra"


# --------------------------------------------------- the server's /docs
def _request(port, path, obj, method="POST"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"}, method=method)
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_server_adds_and_removes_docs_online():
    r = Retriever(MockEncoder(), device="cpu").build_updatable(DOCS, capacity=256)
    server = RetrievalServer(r, port=0, max_wait_s=0.01)
    port = server.start()
    try:
        assert _request(port, "/docs", {"texts": ["zebra stripes in sunlight"],
                                        "ids": ["zebra"]}) == {"ids": ["zebra"]}
        hit = _request(port, "/search", {"queries": ["zebra stripes in sunlight"], "k": 1,
                                         "return_texts": True})["results"][0][0]
        assert hit[0] == "zebra" and hit[2] == "zebra stripes in sunlight"
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as resp:
            assert json.loads(resp.read()) == {"ok": True, "n_docs": 6}
        assert _request(port, "/docs", {"texts": ["auto id"]}) == {"ids": [5]}
        assert _request(port, "/docs", {"ids": ["zebra"]}, method="DELETE") == {"removed": 1}
        rows = _request(port, "/search", {"queries": ["zebra stripes in sunlight"],
                                          "k": 10})["results"][0]
        assert "zebra" not in [row[0] for row in rows] and len(rows) == 6
        for body, method in (({"texts": []}, "POST"), ({"ids": ["missing"]}, "DELETE"),
                             ({"texts": ["dup"], "ids": [5]}, "POST")):
            with pytest.raises(urllib.error.HTTPError) as err:
                _request(port, "/docs", body, method=method)
            assert err.value.code == 400
    finally:
        server.stop()

    static = RetrievalServer(Retriever(MockEncoder(), device="cpu").build(DOCS), port=0)
    port = static.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            _request(port, "/docs", {"texts": ["new doc"]})
        assert err.value.code == 400 and b"static" in err.value.read()
    finally:
        static.stop()


# ------------------------------------------------ the device default
def _entry_points():
    from qst_tpu_torch.cli import index_main
    from qst_tpu_torch.core.config import EncoderConfig, LossConfig, TrainConfig
    from qst_tpu_torch.models.discriminator import init_discriminator
    from qst_tpu_torch.models.sentence_encoder import init_params
    from qst_tpu_torch.train import Trainer, create_train_state

    cfg, gen = EncoderConfig.tiny(), torch.Generator().manual_seed(0)
    emb = hash_embed(_many_docs(40))
    return {
        "resolve_device": lambda: resolve_device(None),
        "device_of_host_array": lambda: device_of(emb),
        "init_params": lambda: init_params(cfg, gen),
        "init_discriminator": lambda: init_discriminator(8, gen),
        "create_train_state": lambda: create_train_state(cfg, TrainConfig(), gen, 10),
        "Trainer": lambda: Trainer(cfg, LossConfig(), TrainConfig(), [0] * 8, None),
        "load_index": lambda: load_index("/nonexistent"),
        "ExactIndex": lambda: ExactIndex(emb),
        "IVFIndex": lambda: IVFIndex(emb, n_clusters=4),
        "IVFIndex.from_arrays": lambda: IVFIndex.from_arrays(
            np.zeros((2, 4)), np.zeros((2, 8, 4)), np.zeros((2, 8)), np.zeros(2)),
        "UpdatableIndex": lambda: UpdatableIndex(8),
        "Retriever": lambda: Retriever(MockEncoder()),
        "index_main": lambda: index_main.main(
            ["query", "--index_dir", "/nonexistent", "--queries", "q", "--encoder_preset", "tiny"]),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_the_gpu_and_raise_without_one(name):
    """No entry point falls back to the CPU: without a CUDA device the
    default raises a clear error, before any work is done."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device.*device='cpu'"):
        _entry_points()[name]()


def test_explicit_and_tensor_devices_win():
    assert resolve_device("cpu") == torch.device("cpu")
    assert device_of(torch.zeros(2)) == torch.device("cpu")      # a tensor fixes it
    assert device_of(np.zeros(2), "cpu") == torch.device("cpu")
    assert ExactIndex(torch.zeros((3, 4)) + 1).device.type == "cpu"

    class OnCpu(MockEncoder):
        device = torch.device("cpu")

    assert Retriever(OnCpu()).device.type == "cpu"               # the encoder's device
