"""The port's IVF-PQ index (``retrieval/ivfpq.py``) against qst_tpu.

A JAX-built index is carried over by ``IVFPQIndex.from_arrays`` (the two
packages draw their k-means and codebook inits differently: a port-built
index is held to the JAX package's own bars instead) and searched alike at
8 and 4 bits, residual and not, n_probe 1 / 4 / all 16 cells and refine 0 /
8. Tolerances: f32 scores 1e-5 absolute (the same products, f32 sums in
another order), ids equal up to ties; reconstructions 1e-6; the cell fill
of chunked builds (``IncrementalCellFill``) exactly.
"""

import numpy as np
import pytest
import torch

from qst_tpu.retrieval import ivfpq as jivfpq
from qst_tpu.retrieval.retriever import Retriever as JaxRetriever
from qst_tpu.retrieval.retriever import load_index as jax_load_index
from qst_tpu_torch.retrieval import IVFPQIndex, Retriever, load_index
from qst_tpu_torch.retrieval import ivfpq as tivfpq
from test_torch_slice import assert_topk_equal_up_to_ties

TOL = dict(rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def corpus():
    """The JAX package's IVF-PQ data (``tests/test_ivfpq.py``): 1,024 docs
    of D = 32 in 16 clusters at noise 1.0 (center scale 4), 24 queries."""
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((16, 32)) * 4
    docs = np.concatenate([centers[i] + rng.standard_normal((64, 32)) * 1.0
                           for i in range(16)]).astype(np.float32)
    rng = np.random.default_rng(1)
    queries = docs[rng.choice(len(docs), 24)] + rng.standard_normal((24, 32)).astype(
        np.float32) * 0.1
    return docs, queries


def _norm(x):
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _positions(ids):
    return np.array([[-1 if j is None else j for j in row] for row in ids])


def _carry(jidx):
    rows = jidx._refine_rows
    if rows is not None and rows.dtype != np.int8:
        rows = np.asarray(rows, np.float32)
    return IVFPQIndex.from_arrays(
        np.asarray(jidx.centroids), np.asarray(jidx.cell_codes), np.asarray(jidx.cell_ids),
        np.asarray(jidx.codebooks), np.asarray(jidx.fill), default_n_probe=4,
        residual=jidx.residual, refine_rows=rows, bits=jidx.bits, device="cpu")


@pytest.fixture(scope="module")
def jax_indexes(corpus):
    return {(bits, residual): jivfpq.IVFPQIndex(corpus[0], n_clusters=16, m=8, seed=0,
                                                 keep_rows=True, residual=residual,
                                                 bits=bits, pq_iters=6, n_iters=5)
            for bits in (8, 4) for residual in (True, False)}


def test_incremental_cell_fill_matches_jax():
    rng = np.random.default_rng(2)
    choices = np.stack([rng.permutation(16)[:4] for _ in range(1500)]).astype(np.int32)
    choices[:300, 0] = 3                        # one crowded first choice: spills
    jfill, tfill = jivfpq.IncrementalCellFill(16, 104), tivfpq.IncrementalCellFill(16, 104)
    for lo, hi in ((0, 400), (400, 401), (401, 1500)):
        for a, b in zip(jfill.place(choices[lo:hi]), tfill.place(choices[lo:hi])):
            np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(tfill.fill, jfill.fill)
    assert tfill.spilled == jfill.spilled > 0
    with pytest.raises(ValueError, match="exhausted"):
        tivfpq.IncrementalCellFill(16, 2).place(choices)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("residual", [True, False])
def test_jax_built_index_carried_over(corpus, jax_indexes, bits, residual):
    _, queries = corpus
    jidx = jax_indexes[(bits, residual)]
    idx = _carry(jidx)
    assert idx.n_docs == jidx.n_docs and idx.cell_budget == jidx.cell_budget
    np.testing.assert_allclose(idx.reconstruct_rows(), jidx.reconstruct_rows(),
                               rtol=0, atol=1e-6)
    for n_probe in (1, 4, 16):
        for refine in (0, 8):
            ws, wids = jidx.search(queries, k=10, n_probe=n_probe, refine_factor=refine)
            gs, gids = idx.search(queries, k=10, n_probe=n_probe, refine_factor=refine)
            assert gs.shape == ws.shape
            assert_topk_equal_up_to_ties(gs, _positions(gids), ws, _positions(wids), **TOL)


def test_full_probe_tools_and_adoption(corpus, jax_indexes):
    """Full probe ≡ the exact top-k over ``reconstruct_rows()``;
    ``tune_n_probe``, ``search_stream`` ≡ ``search``, ``from_device_arrays``
    and the refine's exact cosines on the carried index."""
    _, queries = corpus
    jidx = jax_indexes[(8, True)]
    idx = _carry(jidx)
    recon = idx.reconstruct_rows()
    S = _norm(queries) @ recon.T
    gi = np.argsort(-S, axis=1)[:, :5]
    s, ids = idx.search(queries, k=5, n_probe=16, refine_factor=0)
    assert_topk_equal_up_to_ties(s, _positions(ids), np.take_along_axis(S, gi, 1), gi, **TOL)

    for kw in ({}, {"candidates": [1, 2, 4]}):
        want = jidx.tune_n_probe(queries, k=10, target_recall=0.9, set_default=False, **kw)
        got = idx.tune_n_probe(queries, k=10, target_recall=0.9, set_default=False, **kw)
        assert got == want
    with pytest.raises(ValueError, match="no candidates"):
        idx.tune_n_probe(queries, candidates=[16, 0])
    with pytest.warns(UserWarning, match="exhaustive full probe"):
        idx.tune_n_probe(queries, k=10, target_recall=1.0, candidates=[1], set_default=False)

    batches = [queries[:8], queries[8:16], queries[16:]]
    streamed = list(idx.search_stream(iter(batches), k=5, n_probe=4, depth=2, refine_factor=4))
    s_all, ids_all = idx.search(queries, k=5, n_probe=4, refine_factor=4)
    np.testing.assert_array_equal(np.concatenate([s for s, _ in streamed]), s_all)
    np.testing.assert_array_equal(np.concatenate([i for _, i in streamed]), _positions(ids_all))

    re = IVFPQIndex.from_device_arrays(idx.centroids, idx.cell_codes.clone(), idx.cell_ids,
                                       idx.codebooks, default_n_probe=4)
    assert isinstance(re.ids, range) and re.n_docs == idx.n_docs
    assert torch.equal(re.fill, idx.fill)
    s1, i1 = idx.search(queries, k=5, refine_factor=0)
    s2, i2 = re.search(queries, k=5, refine_factor=0)
    np.testing.assert_array_equal(s1, s2)
    assert i1 == i2
    with pytest.raises(ValueError, match="uint8 tensor"):
        IVFPQIndex.from_device_arrays(idx.centroids, idx.cell_codes.numpy(), idx.cell_ids,
                                      idx.codebooks)

    # the refine's scores are exact cosines over the bf16 rows
    s, ids = idx.search(queries, k=10, n_probe=4, refine_factor=8)
    rows = idx.refine_rows_f32()
    np.testing.assert_allclose(s, np.take_along_axis(_norm(queries) @ rows.T,
                                                     _positions(ids), 1), **TOL)


@pytest.mark.parametrize("bits", [8, 4])
def test_port_built_index(corpus, bits):
    """The port's own build: nothing dropped, residuals reconstruct finer
    than raw codes, recall@10 at n_probe 4 and refine ×4 above the JAX
    package's bar (0.85), full probe exact over the reconstructions; the
    refusals."""
    docs, queries = corpus
    idx = IVFPQIndex(docs, n_clusters=16, m=8, seed=0, keep_rows=True, bits=bits,
                     device="cpu")
    stored = set(idx.cell_ids[idx.cell_ids >= 0].tolist())
    assert stored == set(range(len(docs)))
    raw = IVFPQIndex(docs, n_clusters=16, m=8, seed=0, residual=False, bits=bits,
                     device="cpu")
    mse = [float(np.mean((i.reconstruct_rows() - _norm(docs)) ** 2)) for i in (idx, raw)]
    assert mse[0] < mse[1], mse
    exact = np.argsort(-(_norm(queries) @ _norm(docs).T), axis=1)[:, :10]
    _, got = idx.search(queries, k=10, n_probe=4, refine_factor=4)
    recall = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(exact, got)])
    assert recall > 0.85, recall
    S = _norm(queries) @ idx.reconstruct_rows().T
    gi = np.argsort(-S, axis=1)[:, :5]
    s, ids = idx.search(queries, k=5, n_probe=16, refine_factor=0)
    assert_topk_equal_up_to_ties(s, _positions(ids), np.take_along_axis(S, gi, 1), gi, **TOL)
    for kw, match in (({"m": 24}, "not divisible"), ({"m": 4}, "multiple of 8"),
                      ({"keep_rows": "f64"}, "keep_rows"), ({"ids": [1, 2]}, "ids length"),
                      ({"bits": 6}, "bits")):
        with pytest.raises(ValueError, match=match):
            IVFPQIndex(docs, **{"n_clusters": 16, "m": 8, "device": "cpu", **kw})
    with pytest.raises(TypeError, match="Mesh"):
        IVFPQIndex(docs, n_clusters=16, m=8, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="cos_sim/dot_score"):
        idx.search(queries, score="euclid_score")
    with pytest.raises(ValueError, match="refine_factor needs"):
        raw.search(queries, refine_factor=2)


def test_ivfpq_artifacts_cross_packages(corpus, jax_indexes, tmp_path):
    """JAX's saved IVF-PQ index reloads in the port, the port's in JAX (4
    bits, int8 refine rows)."""
    docs, queries = corpus
    jr = JaxRetriever(None, index_dtype="ivfpq")
    jr.index = jax_indexes[(4, True)]
    jr.save(str(tmp_path / "jax"))
    idx, meta = load_index(str(tmp_path / "jax"), device="cpu")
    assert isinstance(idx, IVFPQIndex) and (meta["bits"], idx.bits) == (4, 4)
    ws, wids = jr.index.search(queries, k=5, n_probe=4)
    gs, gids = idx.search(queries, k=5, n_probe=4)
    assert_topk_equal_up_to_ties(gs, _positions(gids), ws, _positions(wids), **TOL)
    tr = Retriever(None, index_dtype="ivfpq", device="cpu")
    tr.index = IVFPQIndex(docs, n_clusters=16, m=8, keep_rows="int8", bits=8, device="cpu")
    tr.save(str(tmp_path / "port"))
    jidx, meta = jax_load_index(str(tmp_path / "port"))
    assert isinstance(jidx, jivfpq.IVFPQIndex) and jidx._refine_scale == 127.0
    ws, wids = jidx.search(queries, k=5, n_probe=4)
    gs, gids = tr.index.search(queries, k=5, n_probe=4)
    assert_topk_equal_up_to_ties(gs, _positions(gids), ws, _positions(wids), **TOL)


class _HashEncoder:
    def encode(self, texts):
        from helpers import hash_embed

        return hash_embed(list(texts))


@pytest.mark.parametrize("kind", ["pq", "ivfpq"])
def test_retriever_paths_and_updatable_conversion(kind):
    """``Retriever`` over a PQ / IVF-PQ index (``tests/test_ivfpq.py``'s
    recipe): ``search``, ``search_async`` and ``search_stream`` give the same
    rows, refined from the bf16 rows by default; ``to_updatable`` carries the
    refine rows into an exact buffer whose answers are qst_tpu's after its
    own ``to_updatable`` over the same rows (scores 1e-5, ids up to ties)."""
    from qst_tpu.retrieval import Retriever as JaxRetriever

    topics = ["cat", "dog", "pasta", "plane", "river"]
    docs = [f"{topics[i % 5]} document number {i}" for i in range(300)]
    queries = ["a cat rests", "a dog runs", "pasta dish"]
    r = Retriever(_HashEncoder(), index_dtype=kind, pq_m=16, ivf_clusters=8, ivf_probe=8,
                  device="cpu").build(docs)
    rows = r.search(queries, k=4, return_texts=True)
    assert all(len(row) == 4 for row in rows) and rows[0][0][2].startswith("cat")
    assert r.search_async(queries, k=4, return_texts=True)() == rows
    assert list(r.search_stream([queries[:1], queries[1:]], k=4, return_texts=True)) == [
        rows[:1], rows[1:]]
    emb = _HashEncoder().encode(queries)
    table = r.index.refine_rows_f32()
    cos = _norm(emb) @ table.T
    for row, c in zip(rows, cos):
        np.testing.assert_allclose([h[1] for h in row], c[[h[0] for h in row]], **TOL)
    jr = JaxRetriever(_HashEncoder(), index_dtype="float32").build(docs)
    jr.index = type(jr.index)(table)            # the same rows, then JAX's conversion
    jr.to_updatable(capacity=1024)
    r.to_updatable(capacity=1024)
    assert r.index.n_docs == len(docs)
    got, want = r.search(queries, k=4), jr.search(queries, k=4)
    assert_topk_equal_up_to_ties(np.array([[h[1] for h in row] for row in got]),
                                 np.array([[h[0] for h in row] for row in got]),
                                 np.array([[h[1] for h in row] for row in want]),
                                 np.array([[h[0] for h in row] for row in want]), **TOL)
