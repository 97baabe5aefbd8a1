"""K4 (bucket maxima) and K5 (winning-bucket rescore): the port's plain
versions against the TPU kernels in interpret mode, and the exact top-k
pipeline ``topk_v2`` against ``pallas_topk_v2`` and ``reference_topk``.

Tolerances: f32 and bf16 scores rtol 1e-6 / atol 1e-5 (exact products, f32
sums in another order, scores of order 10); int8 scores exactly equal (both
sides sum integers exactly). The edge shapes are those the tensor-core K4 and
the grouped K5 make delicate: a query count that is no multiple of 128, a
ragged last bucket with ``n_real`` inside a bucket, scores that are all
negative (a zero-filled row would win), many queries on one bucket and bucket
ids out of range. The CUDA kernels run only on a GPU (``cuda`` marker; skipped
here).
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qst_tpu.ops import topk_pallas as jt
from qst_tpu_torch.ops import topk as tt

DTYPES = ["float32", "bfloat16", "int8"]
TOL = dict(rtol=1e-6, atol=1e-5)


def _data(name, N, D, Q, seed=0, negative=False):
    rng = np.random.default_rng(seed)
    corpus = rng.standard_normal((N, D)).astype(np.float32)
    queries = rng.standard_normal((Q, D)).astype(np.float32)
    if negative:          # every score below 0: a zero-filled row would win
        corpus, queries = np.abs(corpus), -np.abs(queries)
    if name == "int8":
        corpus = np.clip(np.round(corpus * 40), -127, 127).astype(np.int8)
        queries = np.clip(np.round(queries * 40), -127, 127).astype(np.int8)
        return (jnp.asarray(queries), jnp.asarray(corpus),
                torch.from_numpy(queries), torch.from_numpy(corpus))
    jdt = jnp.bfloat16 if name == "bfloat16" else jnp.float32
    tdt = getattr(torch, name)
    return (jnp.asarray(queries, jdt), jnp.asarray(corpus, jdt),
            torch.from_numpy(queries).to(tdt), torch.from_numpy(corpus).to(tdt))


def _close(got, want, name):
    if name == "int8":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("n_real", [None, 4321])
def test_bucket_maxima_plain_matches_tpu_kernel(name, n_real):
    jq, jc, tq, tc = _data(name, 5000, 64, 20)
    want = np.asarray(jt.bucket_maxima(
        jq, jc, interpret=True, qb2=32,
        n_real=None if n_real is None else jnp.int32(n_real)))
    got = tt.bucket_maxima_plain(tq, tc, n_real).numpy()
    assert got.shape == want.shape == (20, 40)
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    _close(got[fin], want[fin], name)


@pytest.mark.parametrize("name", DTYPES)
def test_rescore_plain_matches_tpu_kernel(name):
    N, D, Q, k = 1000, 32, 13, 3          # N not a bucket multiple
    jq, jc, tq, tc = _data(name, N, D, Q, seed=1)
    ids = np.random.default_rng(2).integers(0, -(-N // tt.BUCKET), (Q, k)).astype(np.int32)
    n_pad = -(-N // tt.BUCKET) * tt.BUCKET
    jc_pad = jnp.pad(jc, ((0, n_pad - N), (0, 0)))
    want = np.asarray(jt.rescore_buckets(jq, jc_pad, jnp.asarray(ids), k, interpret=True))
    got = tt.rescore_buckets_plain(tq, tc, torch.from_numpy(ids), k).numpy()
    rows = ids[:, :, None] * tt.BUCKET + np.arange(tt.BUCKET)
    valid = (rows < N).reshape(Q, k * tt.BUCKET)
    assert np.all(got[~valid] == -np.inf)          # the port masks rows ≥ N
    _close(got[valid], want[valid], name)


# (N, D, Q, n_real): Q no multiple of 128, a ragged last bucket, n_real inside
# a bucket (and, in the second, a whole bucket masked)
EDGE_SHAPES = [(128 * 5 + 37, 48, 130, 600), (128 * 12 + 37, 64, 9, 128 * 11 - 3)]


def _shared_and_bad_ids(ids, n_buckets):
    """Half the queries choose one bucket in slot 0; the last slot of two
    queries is out of range (past the end, negative)."""
    ids = ids.copy()
    ids[: len(ids) // 2, 0] = ids[0, 0]
    ids[1, -1] = n_buckets + 3
    ids[2, -1] = -2
    return ids


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("negative", [False, True])
@pytest.mark.parametrize("shape", EDGE_SHAPES)
def test_bucket_maxima_plain_matches_tpu_kernel_at_edge_shapes(name, negative, shape):
    N, D, Q, n_real = shape
    jq, jc, tq, tc = _data(name, N, D, Q, seed=7, negative=negative)
    n_buckets = -(-N // tt.BUCKET)
    for nr in (None, n_real):
        want = np.asarray(jt.bucket_maxima(
            jq, jc, interpret=True, qb2=32, n_real=None if nr is None else jnp.int32(nr)))
        got = tt.bucket_maxima_plain(tq, tc, nr).numpy()
        assert got.shape == want.shape == (Q, n_buckets)
        assert np.array_equal(np.isinf(got), np.isinf(want))
        fin = np.isfinite(want)
        assert fin[:, : (N if nr is None else nr) // tt.BUCKET].all()
        if negative:
            assert (got[fin] < 0).all()     # no padded row's 0 took a maximum
        _close(got[fin], want[fin], name)


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("negative", [False, True])
def test_rescore_plain_matches_tpu_kernel_on_shared_and_bad_buckets(name, negative):
    N, D, Q, k = 128 * 5 + 37, 48, 40, 4
    n_buckets = -(-N // tt.BUCKET)
    jq, jc, tq, tc = _data(name, N, D, Q, seed=8, negative=negative)
    ids = _shared_and_bad_ids(
        np.random.default_rng(9).integers(0, n_buckets, (Q, k)).astype(np.int32), n_buckets)
    in_range = (ids >= 0) & (ids < n_buckets)
    jc_pad = jnp.pad(jc, ((0, n_buckets * tt.BUCKET - N), (0, 0)))
    # the TPU kernel takes no id out of range: its callers clamp and mask
    want = np.asarray(jt.rescore_buckets(
        jq, jc_pad, jnp.asarray(np.clip(ids, 0, n_buckets - 1)), k, interpret=True))
    got = tt.rescore_buckets_plain(tq, tc, torch.from_numpy(ids), k).numpy()
    rows = ids[:, :, None] * tt.BUCKET + np.arange(tt.BUCKET)
    valid = (in_range[:, :, None] & (rows < N)).reshape(Q, k * tt.BUCKET)
    assert not valid.all() and np.all(got[~valid] == -np.inf)
    _close(got[valid], want[valid], name)


def test_group_pairs_by_bucket_matches_numpy():
    Q, k, n_buckets = 37, 5, 11
    ids = _shared_and_bad_ids(
        np.random.default_rng(10).integers(0, n_buckets, (Q, k)).astype(np.int32), n_buckets)
    sorted_ids, order = tt._group_pairs_by_bucket(torch.from_numpy(ids))
    sorted_ids, order = sorted_ids.numpy(), order.numpy()
    flat = ids.reshape(-1)
    # every (query, slot) pair appears once, under its own bucket id
    np.testing.assert_array_equal(np.sort(order), np.arange(Q * k))
    np.testing.assert_array_equal(flat[order], sorted_ids)
    # the pairs of one bucket are neighbours: one run per distinct id
    np.testing.assert_array_equal(sorted_ids, np.sort(flat))
    assert 1 + np.count_nonzero(np.diff(sorted_ids)) == len(np.unique(flat))


def test_hierarchical_top_buckets_matches_jax():
    bm = np.random.default_rng(3).standard_normal((6, 700)).astype(np.float32)
    for k in (1, 10, 128):
        want = np.asarray(jt._hierarchical_top_buckets(jnp.asarray(bm), k))
        got = tt._hierarchical_top_buckets(torch.from_numpy(bm), k).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("N", [3000, 70])
def test_topk_v2_matches_reference(name, N):
    _, _, tq, tc = _data(name, N, 48, 9, seed=4)
    ts, ti = tt.topk_v2(tq, tc, 10)
    rs, ri = tt.reference_topk(tq, tc, 10)
    # distinct random scores: no ties, so ids agree exactly
    np.testing.assert_array_equal(ti.numpy(), ri.numpy())
    _close(ts.numpy(), rs.numpy(), name)


def test_topk_v2_matches_tpu_pipeline():
    jq, jc, tq, tc = _data("bfloat16", 3000, 48, 9, seed=4)
    js, ji = jt.pallas_topk_v2(jq, jc, 10, interpret=True)
    ts, ti = tt.topk_v2(tq, tc, 10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(ts.numpy(), np.asarray(js), "bfloat16")


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("negative", [False, True])
def test_topk_v2_matches_tpu_pipeline_at_edge_shapes(name, negative):
    N, D, Q, _ = EDGE_SHAPES[0]
    jq, jc, tq, tc = _data(name, N, D, Q, seed=11, negative=negative)
    js, ji = jt.pallas_topk_v2(jq, jc, 5, interpret=True)
    ts, ti = tt.topk_v2(tq, tc, 5)
    rs, ri = tt.reference_topk(tq, tc, 5)
    if name == "int8":    # integer scores tie: the ids are held to their scores
        true = tq.float() @ tc.float().T
        assert torch.equal(torch.gather(true, 1, ti), ts)
    else:
        np.testing.assert_array_equal(ti.numpy(), ri.numpy())
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(ts.numpy(), rs.numpy(), name)
    _close(ts.numpy(), np.asarray(js), name)


def test_wrappers_take_the_plain_versions_on_cpu():
    _, _, tq, tc = _data("bfloat16", 2000, 32, 4)
    before = (tt.bucket_maxima.launches, tt.rescore_buckets.launches)
    bm = tt.bucket_maxima(tq, tc, 1900)
    ids = tt._hierarchical_top_buckets(bm, 5)
    rs = tt.rescore_buckets(tq, tc, ids, 5)
    assert (tt.bucket_maxima.launches, tt.rescore_buckets.launches) == before
    assert torch.equal(bm, tt.bucket_maxima_plain(tq, tc, 1900))
    assert torch.equal(rs, tt.rescore_buckets_plain(tq, tc, ids, 5))


def test_bad_operands_raise():
    _, _, tq, tc = _data("int8", 300, 16, 2)
    with pytest.raises(ValueError, match="int8 corpus needs int8 queries"):
        tt.bucket_maxima(tq.float(), tc)
    with pytest.raises(ValueError, match="share D"):
        tt.bucket_maxima(tq[:, :8], tc)
    with pytest.raises(ValueError, match="bucket_ids"):
        tt.rescore_buckets(tq, tc, torch.zeros((2, 3), dtype=torch.int64), 2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("negative", [False, True])
@pytest.mark.parametrize("shape", [(9000 + 5, 64, 70, 8888), *EDGE_SHAPES,
                                   (128 * 40 + 1, 384, 8, None), (128 * 9, 768, 200, 1100)])
def test_cuda_kernels_match_plain(cuda_device, name, negative, shape):
    N, D, Q, n_real = shape
    _, _, tq, tc = _data(name, N, D, Q, seed=6, negative=negative)
    if name != "int8":    # scores of order 1 at every D, so TOL holds for the wide rows too
        tq = (tq.float() / (D if negative else D ** 0.5)).to(tq.dtype)
    tq, tc = tq.to(cuda_device), tc.to(cuda_device)
    bm = tt.bucket_maxima(tq, tc, n_real)
    bm_ref = tt.bucket_maxima_plain(tq, tc, n_real)
    assert torch.equal(torch.isinf(bm), torch.isinf(bm_ref))
    fin = torch.isfinite(bm_ref)
    _close(bm[fin].cpu().numpy(), bm_ref[fin].cpu().numpy(), name)
    k = 5
    ids = torch.from_numpy(_shared_and_bad_ids(
        tt._hierarchical_top_buckets(bm_ref, k).cpu().numpy(), bm_ref.shape[1])).to(cuda_device)
    rs_ref = tt.rescore_buckets_plain(tq, tc, ids, k)
    rfin = torch.isfinite(rs_ref)
    # both forms of K5: pairs grouped by bucket, and each pair its own block
    for min_pairs in (0, Q * k + 1):
        with mock.patch.object(tt, "_GROUP_MIN_PAIRS", min_pairs):
            rs = tt.rescore_buckets(tq, tc, ids, k)
        assert torch.equal(torch.isinf(rs), torch.isinf(rs_ref))
        _close(rs[rfin].cpu().numpy(), rs_ref[rfin].cpu().numpy(), name)
    ts, ti = tt.topk_v2(tq, tc, k)
    rs_, _ = tt.reference_topk(tq, tc, k)
    true = tq.float() @ tc.float().T
    _close(torch.gather(true, 1, ti).cpu().numpy(), ts.cpu().numpy(), name)
    _close(ts.cpu().numpy(), rs_.cpu().numpy(), name)
