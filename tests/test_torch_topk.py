"""K4 (bucket maxima) and K5 (winning-bucket rescore): the port's plain
versions against the TPU kernels in interpret mode, and the exact top-k
pipeline ``topk_v2`` against ``pallas_topk_v2`` and ``reference_topk``.

Tolerances: f32 and bf16 scores rtol 1e-6 / atol 1e-5 (exact products, f32
sums in another order, scores of order 10); int8 scores exactly equal (both
sides sum integers exactly). The CUDA kernels run only on a GPU (``cuda``
marker; skipped here).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qst_tpu.ops import topk_pallas as jt
from qst_tpu_torch.ops import topk as tt

DTYPES = ["float32", "bfloat16", "int8"]
TOL = dict(rtol=1e-6, atol=1e-5)


def _data(name, N, D, Q, seed=0):
    rng = np.random.default_rng(seed)
    corpus = rng.standard_normal((N, D)).astype(np.float32)
    queries = rng.standard_normal((Q, D)).astype(np.float32)
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
def test_cuda_kernels_match_plain(cuda_device, name):
    _, _, tq, tc = _data(name, 9000 + 5, 64, 70, seed=6)
    tq, tc = tq.to(cuda_device), tc.to(cuda_device)
    bm = tt.bucket_maxima(tq, tc, 8888)
    bm_ref = tt.bucket_maxima_plain(tq, tc, 8888)
    assert torch.equal(torch.isinf(bm), torch.isinf(bm_ref))
    fin = torch.isfinite(bm_ref)
    ids = tt._hierarchical_top_buckets(bm_ref, 10)
    rs, rs_ref = tt.rescore_buckets(tq, tc, ids, 10), tt.rescore_buckets_plain(tq, tc, ids, 10)
    assert torch.equal(torch.isinf(rs), torch.isinf(rs_ref))
    rfin = torch.isfinite(rs_ref)
    _close(bm[fin].cpu().numpy(), bm_ref[fin].cpu().numpy(), name)
    _close(rs[rfin].cpu().numpy(), rs_ref[rfin].cpu().numpy(), name)
