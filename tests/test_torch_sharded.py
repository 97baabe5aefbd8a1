"""The port's sharded indexes against qst_tpu's sharded search.

The port's mesh is ``make_mesh(4, 2)`` over eight ``"cpu"`` positions of
one process (``core/meshes.py``); the JAX side is ``mesh8`` (4 × 2 over the
eight virtual CPU devices) on its ``xla`` backend — the port's kernels'
path (K4 + K5 / K6 plain versions on CPU tensors) is held to its own
unsharded search instead, whose plain versions the other files hold to the
interpreted Pallas kernels. The same numpy inputs go to both packages.
Tolerances: scores 1e-5 (f32; the same products, f32 sums in another
order), ids equal up to ties (``assert_topk_equal_up_to_ties``). PQ, IVF and
IVF-PQ indexes are built by JAX and carried over (``from_codes`` /
``from_arrays``, with the port's mesh): the port's own build draws its
initial centroids from a ``torch.Generator``. The cases mirror ``grep -n
"mesh8\\|sharded" tests/test_{retrieval,int8_index,ivf,pq,ivfpq,
streaming_index}.py``; the ``cuda`` twins run the kernels on one card.
"""

import numpy as np
import pytest
import torch

from qst_tpu.retrieval import ExactIndex as JaxExactIndex
from qst_tpu.retrieval import IVFIndex as JaxIVFIndex
from qst_tpu.retrieval import IVFPQIndex as JaxIVFPQIndex
from qst_tpu.retrieval import PQIndex as JaxPQIndex
from qst_tpu.retrieval import StreamingExactIndex as JaxStreamingIndex
from qst_tpu_torch.core.meshes import RowShards, make_mesh
from qst_tpu_torch.ops import topk as ttopk
from qst_tpu_torch.retrieval import (
    ExactIndex,
    IVFIndex,
    IVFPQIndex,
    PQIndex,
    StreamingExactIndex,
)
from test_torch_slice import assert_topk_equal_up_to_ties

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def tmesh():
    return make_mesh(4, 2, devices=["cpu"] * 8)


def _ids(ids):
    """IVF-style id lists (``None`` past the probed docs) as an int array."""
    return np.array([[-1 if j is None else j for j in row] for row in ids])


def _golden(queries, corpus, k, score):
    if score == "cos_sim":
        c = corpus / np.linalg.norm(corpus, axis=1, keepdims=True)
        s = (queries / np.linalg.norm(queries, axis=1, keepdims=True)) @ c.T
    else:
        s = queries.astype(np.float64) @ corpus.T.astype(np.float64)
    i = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(s, i, 1), i


# ---------------------------------------------------------------- exact

@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(1)
    corpus = rng.standard_normal((1000, 32)).astype(np.float32)
    corpus[500] = corpus[3]                       # an exact tie across shards
    queries = rng.standard_normal((6, 32)).astype(np.float32)
    queries[0] = corpus[3]
    return corpus, queries


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sharded_exact_matches_jax_and_unsharded(data, mesh8, tmesh, dtype):
    corpus, queries = data
    jidx = JaxExactIndex(corpus, mesh=mesh8, dtype=dtype)
    tidx = ExactIndex(corpus, mesh=tmesh, dtype=dtype)
    plain = ExactIndex(corpus, dtype=dtype, device="cpu")
    assert tidx.shard_rows == jidx.shard_rows == 128 and tidx.device == torch.device("cpu")
    assert tuple(tidx.embeddings.gather().shape) == tuple(jidx.embeddings.shape)
    for score in ("cos_sim", "dot_score", "euclid_score"):
        got = tidx.search(queries, k=7, score=score, backend="xla")
        assert_topk_equal_up_to_ties(*got, *jidx.search(queries, k=7, score=score), **TOL)
        if score != "euclid_score":
            kern = tidx.search(queries, k=7, score=score, backend="pallas")
            assert_topk_equal_up_to_ties(*kern, *plain.search(queries, k=7, score=score,
                                                              backend="pallas"), **TOL)
    # the exact tie: the lower shard's row first, as lax.top_k over all_gather
    assert got[1][0, 0] == 3 and 500 in got[1][0]


def test_sharded_exact_non_divisible_and_empty_shards(tmesh, mesh8):
    """101 and 129 rows over 8 shards: 128-row shards, shards 1-7 (101) or
    2-7 (129) hold no document; padding is never returned, also at k = N."""
    rng = np.random.default_rng(0)
    for n in (101, 129):
        corpus = rng.standard_normal((n, 16)).astype(np.float32)
        queries = rng.standard_normal((3, 16)).astype(np.float32)
        tidx = ExactIndex(corpus, mesh=tmesh)
        gs, gi = _golden(queries, corpus, 5, "cos_sim")
        for backend in ("xla", "pallas"):
            s, i = tidx.search(queries, k=5, backend=backend)
            np.testing.assert_array_equal(i, gi)
            np.testing.assert_allclose(s, gs, **TOL)
            # every real row (the kernels take k <= 128): more than a shard holds
            kk = n if backend == "xla" else min(n, 128)
            s, i = tidx.search(queries, k=n + 5 if backend == "xla" else kk,
                               score="dot_score", backend=backend)
            assert i.shape == (3, kk) and np.isfinite(s).all() and i.max() < n
            assert len(set(i[0])) == kk
        js, ji = JaxExactIndex(corpus, mesh=mesh8).search(queries, k=5)
        assert_topk_equal_up_to_ties(*tidx.search(queries, k=5), js, ji, **TOL)


def test_sharded_exact_large_shards_bucketed(tmesh, rng):
    """Shards past 4,096 rows take ``_local_topk``'s bucketed path."""
    N, D, k = 8 * 4096 + 128, 16, 7
    corpus = rng.standard_normal((N, D)).astype(np.float32)
    queries = rng.standard_normal((5, D)).astype(np.float32)
    gs, gi = _golden(queries, corpus, k, "cos_sim")
    idx = ExactIndex(corpus, mesh=tmesh)
    assert idx.shard_rows > 4096
    for backend in ("xla", "pallas"):
        s, i = idx.search(queries, k=k, backend=backend)
        np.testing.assert_array_equal(i, gi)
        np.testing.assert_allclose(s, gs, rtol=1e-4, atol=1e-5)


def test_sharded_int8_matches_jax_and_unsharded(data, mesh8, tmesh):
    corpus, queries = data
    jidx = JaxExactIndex(corpus, dtype="int8", mesh=mesh8)
    tidx = ExactIndex(corpus, dtype="int8", mesh=tmesh)
    single = ExactIndex(corpus, dtype="int8", device="cpu")
    assert tidx._int8_scale == pytest.approx(jidx._int8_scale, rel=1e-6)
    for score in ("cos_sim", "dot_score"):
        js, ji = jidx.search(queries, k=7, score=score)
        for backend in ("xla", "pallas"):
            got = tidx.search(queries, k=7, score=score, backend=backend)
            assert_topk_equal_up_to_ties(*got, js, ji, rtol=1e-6, atol=1e-7)
            assert_topk_equal_up_to_ties(*got, *single.search(queries, k=7, score=score),
                                         rtol=1e-6, atol=1e-7)


def test_sharded_exact_cos_corpus_cache(tmesh, rng):
    """cos through the kernels over a non-normalized corpus: a per-call
    unit-norm copy of each shard, or one kept with cache_cos_corpus."""
    corpus = rng.standard_normal((3000, 16)).astype(np.float32) * 3
    queries = rng.standard_normal((4, 16)).astype(np.float32)
    want = ExactIndex(corpus, device="cpu").search(queries, k=6)
    for cache in (False, True):
        idx = ExactIndex(corpus, mesh=tmesh, cache_cos_corpus=cache)
        got = idx.search(queries, k=6, backend="pallas")
        assert_topk_equal_up_to_ties(*got, *want, **TOL)
        assert (idx._cos_corpus is not None) == cache
        if cache:
            assert len(idx._cos_corpus) == 8


def test_mesh_argument_is_checked(data):
    corpus, _ = data
    with pytest.raises(TypeError, match="Mesh"):
        ExactIndex(corpus, mesh=object(), device="cpu")
    one = make_mesh(1, 1, devices=["cpu"])            # one position: the unsharded path
    idx = ExactIndex(corpus, mesh=one)
    assert idx.mesh is None and idx.embeddings.shape == corpus.shape


# ---------------------------------------------------------------- IVF

def _blobs():
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((16, 32)) * 4
    return np.concatenate([
        centers[i] + rng.standard_normal((64, 32)) * 0.3 for i in range(16)
    ]).astype(np.float32)


@pytest.fixture(scope="module")
def clustered():
    return _blobs()


def _carry_ivf(jidx, tmesh, dtype="float32"):
    return IVFIndex.from_arrays(np.asarray(jidx.centroids), np.asarray(jidx.cells, np.float32),
                                np.asarray(jidx.cell_ids), np.asarray(jidx.fill),
                                ids=list(jidx.ids), mesh=tmesh, dtype=dtype, device="cpu")


@pytest.mark.parametrize("n_clusters,budget", [(16, None), (13, 256)])
def test_sharded_ivf_matches_jax_and_unsharded(clustered, mesh8, tmesh, n_clusters, budget):
    """13 cells do not divide the 8 shards (padded trailing cells); the
    K6 path (probes another shard owns at the sentinel cell) and the
    clamp-gather scan against JAX's sharded scan and the port unsharded."""
    rng = np.random.default_rng(3)
    queries = rng.standard_normal((9, 32)).astype(np.float32)
    single = JaxIVFIndex(clustered, n_clusters=n_clusters, seed=0, cell_budget=budget)
    jshard = JaxIVFIndex.from_arrays(single.centroids, single.cells, single.cell_ids,
                                     single.fill, mesh=mesh8)
    tidx = _carry_ivf(single, tmesh)
    plain = _carry_ivf(single, None)
    assert tidx.cells_per_shard == jshard.cells_per_shard == 2
    assert tidx.cells.gather().shape[0] == jshard.cells.shape[0] == 16
    for n_probe in (2, 5, n_clusters):
        js, ji = jshard.search(queries, k=7, n_probe=n_probe)
        for backend in ("xla", "pallas"):
            s, i = tidx.search(queries, k=7, n_probe=n_probe, backend=backend)
            assert_topk_equal_up_to_ties(s, _ids(i), js, _ids(ji), **TOL)
            ps, pi = plain.search(queries, k=7, n_probe=n_probe, backend=backend)
            np.testing.assert_allclose(s, ps, **TOL)
            assert_topk_equal_up_to_ties(s, _ids(i), ps, _ids(pi), **TOL)


def test_sharded_ivf_build_compact_and_reconstruct(clustered, tmesh):
    """The port's own sharded build equals its unsharded build from the
    same seed; ``compact()`` and ``reconstruct_rows`` see through the
    padding, and ``from_arrays(mesh=)`` of the real cells gives the index
    back."""
    rng = np.random.default_rng(9)
    queries = rng.standard_normal((7, 32)).astype(np.float32)
    for kw in ({}, {"dtype": "bfloat16"}):
        single = IVFIndex(clustered, n_clusters=16, seed=0, device="cpu", **kw)
        shard = IVFIndex(clustered, n_clusters=16, seed=0, mesh=tmesh, **kw)
        before = shard.search(queries, k=7, n_probe=5, backend="pallas")
        want = single.search(queries, k=7, n_probe=5, backend="pallas")
        np.testing.assert_array_equal(before[0], want[0])
        assert before[1] == want[1]
        dtype = shard.cells.dtype
        shard.compact()
        assert isinstance(shard.cells, RowShards)
        assert shard.cells.dtype == dtype and shard.mesh is tmesh
        after = shard.search(queries, k=7, n_probe=5, backend="pallas")
        np.testing.assert_array_equal(after[0], before[0])
        assert after[1] == before[1]
        np.testing.assert_array_equal(shard.reconstruct_rows(), single.reconstruct_rows())


# ---------------------------------------------------------------- PQ

@pytest.fixture(scope="module")
def pq_data():
    rng = np.random.default_rng(0)
    corpus = rng.standard_normal((3000, 32)).astype(np.float32)
    queries = rng.standard_normal((8, 32)).astype(np.float32)
    return corpus, queries


@pytest.mark.parametrize("rotate", [False, True])
def test_sharded_pq_matches_jax_and_unsharded(pq_data, mesh8, tmesh, rotate):
    """PQ over the 8 shards (4,096-row shards: the quantum of 375 rows),
    carried from JAX's index through from_codes(mesh=), against JAX's
    sharded scan; the port's scan and kernels' path against its unsharded
    search; the refine stays the host's."""
    corpus, queries = pq_data
    kw = dict(m=8, n_iters=4, rotate=rotate, seed=4, keep_rows=True)
    jidx = JaxPQIndex(corpus, **kw)
    args = (np.asarray(jidx.codes)[: jidx.n_docs], np.asarray(jidx.codebooks))
    extra = dict(refine_rows=jidx.refine_rows_f32(),
                 rotation=None if not rotate else np.asarray(jidx._rotation))
    jshard = JaxPQIndex.from_codes(*args, mesh=mesh8, **extra)
    tidx = PQIndex.from_codes(*args, mesh=tmesh, **extra)
    plain = PQIndex.from_codes(*args, device="cpu", **extra)
    assert tidx.shard_rows == jshard.shard_rows and tidx.codes.gather().shape == jshard.codes.shape
    for rf in (0, 2):
        js, ji = jshard.search(queries, k=10, refine_factor=rf)
        for backend in ("xla", "pallas"):
            got = tidx.search(queries, k=10, refine_factor=rf, backend=backend)
            assert_topk_equal_up_to_ties(*got, js, ji, **TOL)
            assert_topk_equal_up_to_ties(*got, *plain.search(queries, k=10, refine_factor=rf,
                                                             backend=backend), **TOL)


def test_sharded_pq_from_chunks_and_build(pq_data, tmesh):
    corpus, queries = pq_data
    built = PQIndex(corpus, m=8, n_iters=4, mesh=tmesh)
    single = PQIndex(corpus, m=8, n_iters=4, device="cpu")
    assert_topk_equal_up_to_ties(*built.search(queries, k=10), *single.search(queries, k=10),
                                 **TOL)
    chunks = PQIndex.from_chunks([corpus[:1500], corpus[1500:]], m=8, n_iters=4,
                                 train_sample=1500, mesh=tmesh)
    assert chunks.mesh is tmesh and chunks.device == torch.device("cpu")
    assert chunks.codes.gather().shape[0] == 8 * chunks.shard_rows


# ---------------------------------------------------------------- IVF-PQ

@pytest.mark.parametrize("bits", [8, 4])
def test_sharded_ivfpq_matches_jax_and_unsharded(clustered, mesh8, tmesh, bits):
    rng = np.random.default_rng(5)
    queries = rng.standard_normal((10, 32)).astype(np.float32)
    kw = dict(n_clusters=13, m=8, seed=0, bits=bits, keep_rows=True)
    jidx = JaxIVFPQIndex(clustered, **kw)
    args = (np.asarray(jidx.centroids), np.asarray(jidx.cell_codes), np.asarray(jidx.cell_ids),
            np.asarray(jidx.codebooks), np.asarray(jidx.fill))
    extra = dict(ids=list(jidx.ids), bits=bits, refine_rows=jidx.refine_rows_f32())
    jshard = JaxIVFPQIndex.from_arrays(*args, mesh=mesh8, **extra)
    tidx = IVFPQIndex.from_arrays(*args, mesh=tmesh, **extra)
    plain = IVFPQIndex.from_arrays(*args, device="cpu", **extra)
    assert tidx.cell_codes.gather().shape[0] == jshard.cell_codes.shape[0] == 16
    for n_probe in (4, 13):
        for rf in (0, 4):
            s, i = tidx.search(queries, k=5, n_probe=n_probe, refine_factor=rf)
            if not rf and n_probe == 4:   # refined: a tie at the pool's edge may move it
                js, ji = jshard.search(queries, k=5, n_probe=n_probe, refine_factor=0)
                assert_topk_equal_up_to_ties(s, _ids(i), js, _ids(ji), **TOL)
            ps, pi = plain.search(queries, k=5, n_probe=n_probe, refine_factor=rf)
            np.testing.assert_array_equal(s, ps)    # 4-bit codes repeat: ties
            assert_topk_equal_up_to_ties(s, _ids(i), ps, _ids(pi), rtol=0, atol=0)
    # padded cells past the centroids: the residual reconstruction clamps
    np.testing.assert_array_equal(tidx.reconstruct_rows(), plain.reconstruct_rows())


# ---------------------------------------------------------------- streaming

@pytest.mark.parametrize("n_docs,tile_rows", [(5000, 1024), (3000, 2048), (900, 1024)])
def test_sharded_streaming_exact_vs_reference(rng, tmesh, n_docs, tile_rows):
    """Row-sharded tiles stay exact for partial tiles (tiles whose trailing
    shards hold only padding), through the scan and the kernels' path."""
    D, Q, k = 32, 6, 7
    corpus = rng.standard_normal((n_docs, D)).astype(np.float32)
    queries = rng.standard_normal((Q, D)).astype(np.float32)
    idx = StreamingExactIndex(corpus, tile_rows=tile_rows, transfer_dtype="float32",
                              mesh=tmesh)
    for score in ("cos_sim", "dot_score"):
        gs, gi = _golden(queries, corpus, k, score)
        for backend in ("xla", "pallas"):
            s, i = idx.search(queries, k=k, score=score, backend=backend)
            np.testing.assert_array_equal(i, gi)
            np.testing.assert_allclose(s, gs, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("transfer", ["bfloat16", "int8"])
def test_sharded_streaming_matches_jax_and_unsharded(rng, mesh8, tmesh, transfer):
    corpus = rng.standard_normal((4100, 32)).astype(np.float32)
    queries = rng.standard_normal((5, 32)).astype(np.float32)
    jshard = JaxStreamingIndex(corpus, tile_rows=2048, transfer_dtype=transfer, mesh=mesh8)
    shard = StreamingExactIndex(corpus, tile_rows=2048, transfer_dtype=transfer, mesh=tmesh)
    plain = StreamingExactIndex(corpus, tile_rows=2048, transfer_dtype=transfer, device="cpu")
    for score in ("cos_sim", "dot_score"):
        js, ji = jshard.search(queries, k=9, score=score, backend="xla")
        for backend in ("xla", "pallas"):
            got = shard.search(queries, k=9, score=score, backend=backend)
            assert_topk_equal_up_to_ties(*got, js, ji, rtol=1e-5, atol=1e-6)
            want = plain.search(queries, k=9, score=score, backend=backend)
            np.testing.assert_array_equal(got[0], want[0])
            assert_topk_equal_up_to_ties(*got, *want, rtol=0, atol=0)


def test_sharded_streaming_tile_quantum(rng, tmesh):
    corpus = rng.standard_normal((3000, 16)).astype(np.float32)
    with pytest.raises(ValueError, match="mesh devices"):
        StreamingExactIndex(corpus, tile_rows=512, mesh=tmesh)      # 512 < 128 × 8
    with pytest.raises(TypeError, match="Mesh"):
        StreamingExactIndex(corpus, mesh=object(), device="cpu")


# ---------------------------------------------------------------- on a card

@pytest.mark.cuda
@pytest.mark.parametrize("n", [129, 3 * 65536 + 77])
def test_sharded_exact_kernels_on_the_card(n):
    """K4 + K5 in every shard of a 4 × 2 mesh of one card (shards with no
    real row at N = 129), launch counts exact, against the plain versions
    on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a GPU")
    rng = np.random.default_rng(2)
    corpus = torch.from_numpy(rng.standard_normal((n, 384)).astype(np.float32)).cuda()
    queries = torch.from_numpy(rng.standard_normal((64, 384)).astype(np.float32)).cuda()
    mesh = make_mesh(4, 2, devices=["cuda:0"] * 8)
    for dtype in ("bfloat16", "int8"):
        idx = ExactIndex(corpus, mesh=mesh, dtype=dtype, normalize=dtype != "int8")
        plain = ExactIndex(corpus, dtype=dtype, normalize=dtype != "int8")
        before = (ttopk.bucket_maxima.launches, ttopk.rescore_buckets.launches)
        got = idx.search(queries, k=10, backend="pallas")
        after = (ttopk.bucket_maxima.launches, ttopk.rescore_buckets.launches)
        assert (after[0] - before[0], after[1] - before[1]) == (8, 8)
        assert_topk_equal_up_to_ties(*got, *plain.search(queries, k=10, backend="xla"),
                                     rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
def test_sharded_ivf_kernel_on_the_card(clustered):
    """K6 once a shard over 13 cells on a 4 × 2 mesh of one card (probes
    another shard owns score −inf at the sentinel), against the scan."""
    if not torch.cuda.is_available():
        pytest.skip("needs a GPU")
    from qst_tpu_torch.ops import ivf as tivf_ops

    rng = np.random.default_rng(6)
    queries = rng.standard_normal((300, 32)).astype(np.float32)
    mesh = make_mesh(4, 2, devices=["cuda:0"] * 8)
    idx = IVFIndex(torch.from_numpy(clustered).cuda(), n_clusters=13, seed=0,
                   cell_budget=256, mesh=mesh)
    before = tivf_ops.ivf_cell_scores.launches
    got = idx.search(queries, k=7, n_probe=5, backend="pallas")
    assert tivf_ops.ivf_cell_scores.launches - before == 8
    want = idx.search(queries, k=7, n_probe=5, backend="xla")
    assert_topk_equal_up_to_ties(got[0], _ids(got[1]), want[0], _ids(want[1]),
                                 rtol=1e-5, atol=1e-5)
