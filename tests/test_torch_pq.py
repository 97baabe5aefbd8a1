"""The port's PQ index (``retrieval/pq.py``, ``retrieval/pq4.py``) and
``topk_local`` (``ops/topk.py``) against qst_tpu.

Inputs are made with numpy from a seed and fed to both packages; the Pallas
top-k runs with ``interpret=True`` on the JAX side and through the plain K4
and K5 on the port's (CPU tensors). Tolerances: f32 scores 1e-5 absolute
(the same products, f32 sums in another order), ids equal up to ties
(``lax.top_k`` and ``torch.topk`` order equal scores differently); nibble
packing, blocked codebooks and the two decoders exactly. Codes agree except
where a point's two best centroids lie within 1e-5 of each other (the
fits' sums run in another order); those are counted and must be rare.
Lloyd runs from JAX's own initial codebooks (the two packages draw
different ones) and agrees within 1e-5. A JAX-built index is carried over
by ``PQIndex.from_codes``. The CUDA kernels run only on a GPU (``cuda``
marker; skipped here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qst_tpu.ops.topk_pallas import pallas_topk_local
from qst_tpu.retrieval import pq as jpq
from qst_tpu.retrieval import pq4 as jpq4
from qst_tpu.retrieval import ivfpq as jivfpq
from qst_tpu.retrieval.retriever import Retriever as JaxRetriever
from qst_tpu.retrieval.retriever import load_index as jax_load_index
from qst_tpu_torch.ops import topk as tt
from qst_tpu_torch.retrieval import PQIndex, Retriever, load_index
from qst_tpu_torch.retrieval import ivfpq as tivfpq
from qst_tpu_torch.retrieval import pq as tpq
from qst_tpu_torch.retrieval import pq4 as tpq4
from test_torch_slice import assert_topk_equal_up_to_ties

TOL = dict(rtol=0, atol=1e-5)
D, M = 64, 8


def _unit(x):
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def corpus():
    """3,000 rows in 24 planted blobs, and 9 queries near corpus rows."""
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((24, D))
    x = centers[rng.integers(0, 24, 3000)] + 0.4 * rng.standard_normal((3000, D))
    q = x[rng.integers(0, 3000, 9)] + 0.1 * rng.standard_normal((9, D))
    return x.astype(np.float32), q.astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def test_pq4_packing_blocking_and_decode_exactly():
    rng = np.random.default_rng(1)
    cb = rng.standard_normal((16, 16, 4)).astype(np.float32)
    vec = rng.standard_normal((300, 64)).astype(np.float32)
    packed = np.array(jpq4.pq4_encode(jnp.asarray(vec), jnp.asarray(cb)))
    got = tpq4.pq4_encode(_t(vec), _t(cb)).numpy()
    assert got.dtype == np.uint8 and got.shape == (300, 8)
    np.testing.assert_array_equal(got, packed)
    np.testing.assert_array_equal(tpq4.unpack_nibbles(torch.from_numpy(packed)).numpy(),
                                  np.asarray(jpq4.unpack_nibbles(jnp.asarray(packed))))
    blk = tpq4.block_codebooks(_t(cb))
    np.testing.assert_array_equal(blk.numpy(), np.asarray(jpq4.block_codebooks(jnp.asarray(cb))))
    want = np.asarray(jpq4.pq4_reconstruct(jnp.asarray(packed), jnp.asarray(cb)))
    np.testing.assert_array_equal(tpq4.pq4_reconstruct(torch.from_numpy(packed), _t(cb)).numpy(),
                                  want)
    np.testing.assert_array_equal(tpq4.decode4_gather(torch.from_numpy(packed), _t(cb)).numpy(),
                                  want)
    assert tpq4.n_groups(64) == 2 and tpq4.validate_pq4_dims(64, 16) == (4, 1)
    for bad in ((64, 15), (64, 24)):
        with pytest.raises(ValueError):
            tpq4.validate_pq4_dims(*bad)
    assert abs(tpq4.pq4_mse(_t(vec), _t(cb)) - jpq4.pq4_mse(jnp.asarray(vec), jnp.asarray(cb))) \
        < 1e-6


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_aniso_fit_matches_jax(eta):
    rng = np.random.default_rng(2)
    xs = rng.standard_normal((M, 500, 8)).astype(np.float32) * 0.3
    cb = rng.standard_normal((M, 256, 8)).astype(np.float32) * 0.3
    want = np.asarray(jpq._aniso_fit(jnp.asarray(xs), jnp.asarray(cb), eta))
    np.testing.assert_allclose(tpq._aniso_fit(_t(xs), _t(cb), eta).numpy(), want, **TOL)


def _jax_init(sample_sub, key, k):
    """JAX's initial codebooks: its draw of k sample rows, per subspace."""
    idx = np.asarray(jax.random.choice(key, sample_sub.shape[1], (k,), replace=False))
    return sample_sub[:, idx, :]


@pytest.mark.parametrize("kind", ["pq_train", "pq_train_eta", "pq_train_raw", "pq4_train"])
def test_lloyd_from_jax_init_matches(corpus, kind):
    x = corpus[0][:2048]
    key = jax.random.key(3)
    if kind.startswith("pq_train") and kind != "pq_train_raw":
        eta = 0.5 if kind == "pq_train_eta" else 0.0
        want = np.asarray(jpq.pq_train(jnp.asarray(x), key, M, 6, eta=eta))
        xs = np.transpose(_unit(x).reshape(-1, M, D // M), (1, 0, 2))
        got = tpq.pq_train(_t(x), None, M, 6, eta=eta, init=_t(_jax_init(xs, key, 256)))
    elif kind == "pq_train_raw":
        want = np.asarray(jivfpq.pq_train_raw(jnp.asarray(x), key, M, 6))
        xs = np.transpose(x.reshape(-1, M, D // M), (1, 0, 2))
        got = tivfpq.pq_train_raw(_t(x), None, M, 6, init=_t(_jax_init(xs, key, 256)))
    else:
        want = np.asarray(jpq4.pq4_train(jnp.asarray(x), key, 16, 6))
        xs = np.transpose(x.reshape(-1, 16, 4), (1, 0, 2))
        got = tpq4.pq4_train(_t(x), None, 16, 6, init=_t(_jax_init(xs, key, 16)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _near_ties(fit: np.ndarray) -> np.ndarray:
    """(m, B, K) fits → (B, m) True where the two best lie within 1e-5."""
    top2 = np.sort(fit, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0] < 1e-5).T


@pytest.mark.parametrize("kind", ["pq_encode", "pq_encode_eta", "pq_encode_raw"])
def test_codes_match_jax_except_near_ties(corpus, kind):
    x = corpus[0]
    rng = np.random.default_rng(4)
    cb = (rng.standard_normal((M, 256, 8)) * 0.35).astype(np.float32)
    eta = 0.5 if kind == "pq_encode_eta" else 0.0
    if kind == "pq_encode_raw":
        want = np.asarray(jivfpq.pq_encode_raw(jnp.asarray(x), jnp.asarray(cb)))
        got = tivfpq.pq_encode_raw(_t(x), _t(cb)).numpy()
        xs = np.transpose(x.reshape(-1, M, 8), (1, 0, 2))
    else:
        want = np.asarray(jpq.pq_encode(jnp.asarray(x), jnp.asarray(cb), eta=eta))
        got = tpq.pq_encode(_t(x), _t(cb), eta=eta).numpy()
        xs = np.transpose(_unit(x).reshape(-1, M, 8), (1, 0, 2))
    ties = _near_ties(np.asarray(jpq._aniso_fit(jnp.asarray(xs), jnp.asarray(cb), eta)))
    differ = got != want
    assert not (differ & ~ties).any(), np.argwhere(differ & ~ties)[:5]
    # counted: the near ties are a few in the 24,000 codes (≤ 0.1%)
    assert differ.sum() <= ties.sum() <= 24, (differ.sum(), ties.sum())


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4])
def test_onehot_and_gather_decode_are_bitwise_equal(name, bits):
    rng = np.random.default_rng(5)
    dt = getattr(torch, name)
    if bits == 8:
        cb = torch.from_numpy(rng.standard_normal((M, 256, 8)).astype(np.float32)).to(dt)
        codes = torch.from_numpy(rng.integers(0, 256, (5000, M)).astype(np.uint8))
    else:
        cb = torch.from_numpy(rng.standard_normal((16, 16, 4)).astype(np.float32)).to(dt)
        codes = torch.from_numpy(rng.integers(0, 256, (5000, 8)).astype(np.uint8))
    one = tivfpq._decode_any(codes, cb, bits, "onehot")
    gat = tivfpq._decode_any(codes, cb, bits, "gather")
    assert one.dtype == gat.dtype == dt and one.shape == (5000, 64)
    assert torch.equal(one, gat)
    if bits == 8:   # and the one-hot decode is the JAX package's
        want = np.asarray(jpq._decode_onehot(jnp.asarray(codes.numpy()),
                                             jnp.asarray(cb.float().numpy())))
        np.testing.assert_array_equal(tpq._decode_onehot(codes, cb.float()).numpy(), want)


def _codes_cb(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, M)).astype(np.uint8),
            (rng.standard_normal((M, 256, 8)) * 0.35).astype(np.float32))


@pytest.mark.parametrize("n_pad, n_real", [(4096, 4000), (2 * 65536, 65536 + 300)])
def test_pq_topk_matches_jax(n_pad, n_real):
    """One tile, and two score tiles (just past PQ_SCORE_TILE) with the
    second nearly all padding."""
    codes, cb = _codes_cb(n_pad, 6)
    q = np.random.default_rng(7).standard_normal((5, D)).astype(np.float32)
    ws, wi = jpq.pq_topk(jnp.asarray(q), jnp.asarray(codes), jnp.asarray(cb),
                         jnp.full((1,), n_real, jnp.int32), 10)
    recon = tpq._decode_rows(torch.from_numpy(codes), _t(cb), "gather").numpy()[:n_real]
    true = _unit(q) @ recon.T
    for decode in ("onehot", "gather"):
        gs, gi = tpq.pq_topk(_t(q), torch.from_numpy(codes), _t(cb), n_real, 10, decode=decode)
        assert_topk_equal_up_to_ties(gs.numpy(), gi.numpy(), np.asarray(ws), np.asarray(wi),
                                     **TOL)
        np.testing.assert_allclose(np.take_along_axis(true, gi.numpy(), 1), gs.numpy(), **TOL)


def test_super_tile_matches_pallas_interpret():
    codes, cb = _codes_cb(4096, 8)
    q = np.random.default_rng(9).standard_normal((6, D)).astype(np.float32)
    ws, wi = jpq._pq_super_tile_topk(jnp.asarray(q), jnp.asarray(codes), jnp.asarray(cb),
                                     jnp.int32(3000), jnp.int32(8192), 10, "onehot", True)
    gs, gi = tpq._pq_super_tile_topk(_t(q), torch.from_numpy(codes), _t(cb), 3000, 8192, 10,
                                     "gather")
    assert_topk_equal_up_to_ties(gs.numpy(), gi.numpy(), np.asarray(ws), np.asarray(wi), **TOL)
    assert (gi.numpy() >= 8192).all() and (gi.numpy() < 8192 + 3000).all()


@pytest.mark.parametrize("n_local", [4000, 300, 0])
def test_topk_local_matches_pallas_interpret(n_local):
    """n_local inside the last bucket; 300 rows = 3 finite buckets for k =
    10 (the selection lands in the −inf range, clamped and masked); none."""
    rng = np.random.default_rng(10)
    c = rng.standard_normal((4096, D)).astype(np.float32)
    q = rng.standard_normal((8, D)).astype(np.float32)
    ws, wi = pallas_topk_local(jnp.asarray(q), jnp.asarray(c), 10, jnp.int32(n_local),
                               interpret=True)
    gs, gi = tt.topk_local(_t(q), _t(c), 10, n_local)
    ps, pi = tt.topk_local_plain(_t(q), _t(c), 10, n_local)
    assert torch.equal(gs, ps) and torch.equal(gi, pi)
    ws, wi, gs, gi = np.asarray(ws), np.asarray(wi), gs.numpy(), gi.numpy()
    np.testing.assert_array_equal(np.isneginf(gs), np.isneginf(ws))
    assert np.isneginf(gs).sum() == 8 * max(0, 10 - n_local)
    fin = np.isfinite(ws).all(axis=0)
    if fin.any():
        assert_topk_equal_up_to_ties(gs[:, fin], gi[:, fin], ws[:, fin], wi[:, fin], **TOL)
    assert (gi[np.isfinite(gs)] < n_local).all()


def test_refine_pair_host_equals_device():
    rng = np.random.default_rng(11)
    table = _unit(rng.standard_normal((500, D))).astype(np.float32)
    q = rng.standard_normal((7, D)).astype(np.float32)
    idx = rng.integers(0, 500, (7, 40))
    idx[0, 5:] = -1          # a short candidate row
    for rows, scale in ((torch.from_numpy(table).to(torch.bfloat16), 1.0),
                        (np.clip(np.round(table * 127), -127, 127).astype(np.int8), 127.0)):
        host = tpq.refine_pair(q, rows, idx, 10, scale, 500)
        try:
            tpq.REFINE_ON_HOST = False
            dev = tpq.refine_pair(_t(q), rows, idx, 10, scale, 500)
        finally:
            tpq.REFINE_ON_HOST = True
        jrows = np.asarray(rows.float()) if isinstance(rows, torch.Tensor) else rows
        want = jpq.refine_pair(q, jrows, idx, 10, scale, 500)
        for got in (host, dev):      # row 0 holds 5 candidates, the rest 40
            assert_topk_equal_up_to_ties(got[0][1:], got[1][1:], want[0][1:], want[1][1:],
                                         **TOL)
            assert_topk_equal_up_to_ties(got[0][:1, :5], got[1][:1, :5], want[0][:1, :5],
                                         want[1][:1, :5], **TOL)
            assert (got[1][0, 5:] == -1).all() and np.isneginf(got[0][0, 5:]).all()


@pytest.mark.parametrize("keep", ["bfloat16", "int8"])
def test_jax_built_index_carried_over(corpus, keep):
    """A JAX PQIndex (rotated, with refine rows) through ``from_codes``:
    the same answers raw and refined, on both backends."""
    x, q = corpus
    jidx = jpq.PQIndex(x, m=M, keep_rows=keep, rotate=True, n_iters=4)
    rows = jidx._refine_rows
    rows = rows if rows.dtype == np.int8 else np.asarray(rows, np.float32)
    idx = PQIndex.from_codes(np.asarray(jidx.codes)[: jidx.n_docs], np.asarray(jidx.codebooks),
                             refine_rows=rows, rotation=np.asarray(jidx._rotation),
                             device="cpu")
    assert idx.codes.shape == tuple(jidx.codes.shape) and idx._refine_scale == jidx._refine_scale
    for refine in (0, None):
        want = jidx.search(q, k=7, refine_factor=refine, backend="xla")
        for backend in ("xla", "pallas"):
            got = idx.search(q, k=7, refine_factor=refine, backend=backend)
            assert_topk_equal_up_to_ties(*got, *want, **TOL)
    assert abs(idx.reconstruction_mse(x[:200]) - jidx.reconstruction_mse(x[:200])) < 1e-6
    np.testing.assert_allclose(idx.refine_rows_f32(), jidx.refine_rows_f32(), rtol=0, atol=0)
    ss = list(idx.search_stream([q[:4], q[4:]], k=7, depth=2, refine_factor=8))
    s, i = idx.search(q, k=7, refine_factor=8)
    np.testing.assert_array_equal(np.concatenate([p[0] for p in ss]), s)


def test_port_built_index_and_its_options(corpus):
    """The port's own build (its draws) on the JAX package's recall data
    (``tests/test_pq.py``: 700 rows of D = 32 in 32 tight clusters): the
    refine's scores are exact cosines and recall@10 at refine ×8 meets that
    test's 0.9, plain, rotated and anisotropic; from_chunks; refusals."""
    rng = np.random.default_rng(7)

    def clustered(n):
        centers = rng.standard_normal((32, 32)).astype(np.float32)
        return (centers[rng.integers(0, 32, n)]
                + 0.05 * rng.standard_normal((n, 32)).astype(np.float32))

    x, q = clustered(700), clustered(9)
    exact = np.argsort(-(_unit(q) @ _unit(x).T), axis=1)[:, :10]
    for kw in ({}, {"rotate": True}, {"anisotropic": 0.5}):
        idx = PQIndex(x, m=M, keep_rows=True, device="cpu", n_iters=6, **kw)
        s, i = idx.search(q, k=10)                          # default refine x8
        np.testing.assert_allclose(s, np.take_along_axis(
            _unit(q) @ idx.refine_rows_f32().T, i, 1), **TOL)
        recall = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(i, exact)])
        assert recall >= 0.9, (kw, recall)
    x, q = corpus
    chunks = PQIndex.from_chunks([x[:1000], x[1000:]], m=M, train_sample=1500, n_iters=6,
                                 device="cpu")
    assert chunks.n_docs == 3000 and chunks._refine_rows is None
    with pytest.raises(ValueError, match="keep_rows"):
        chunks.search(q, refine_factor=2)
    with pytest.raises(TypeError, match="Mesh"):
        PQIndex(x, m=M, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="multiple of 8"):
        PQIndex(x, m=4, device="cpu")


def test_pq_artifacts_cross_packages(corpus, tmp_path):
    """JAX's saved PQ index reloads in the port and the port's in JAX."""
    x, q = corpus
    jr = JaxRetriever(None, index_dtype="pq")
    jr.index = jpq.PQIndex(x, m=M, keep_rows=True, rotate=True, n_iters=4)
    jr.save(str(tmp_path / "jax"))
    idx, meta = load_index(str(tmp_path / "jax"), device="cpu")
    assert isinstance(idx, PQIndex) and meta["dtype"] == "pq"
    assert_topk_equal_up_to_ties(*idx.search(q, k=5), *jr.index.search(q, k=5), **TOL)
    tr = Retriever(None, index_dtype="pq", device="cpu")
    tr.index = PQIndex(x, m=M, keep_rows="int8", n_iters=4, device="cpu")
    tr.save(str(tmp_path / "port"))
    jidx, meta = jax_load_index(str(tmp_path / "port"))
    assert isinstance(jidx, jpq.PQIndex) and jidx._refine_scale == 127.0
    assert_topk_equal_up_to_ties(*jidx.search(q, k=5, backend="xla"), *tr.index.search(q, k=5),
                                 **TOL)


@pytest.mark.cuda
def test_topk_local_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a GPU")
    gen = torch.Generator().manual_seed(12)
    for dtype, Q, rows, n_local in ((torch.bfloat16, 256, 1 << 16, (1 << 16) - 300),
                                    (torch.float32, 37, 4096, 300),
                                    (torch.int8, 300, 8192, 5000)):
        c = torch.randn((rows, 384), generator=gen)
        q = torch.randn((Q, 384), generator=gen)
        if dtype == torch.int8:
            c, q = (torch.clamp(torch.round(t * 40), -127, 127).to(torch.int8) for t in (c, q))
        c, q = c.to("cuda", dtype), q.to("cuda", dtype)
        got = tt.topk_local(q, c, 10, n_local)
        want = tt.topk_local_plain(q, c, 10, n_local)
        torch.cuda.synchronize()
        assert torch.equal(torch.isneginf(got[0]), torch.isneginf(want[0]))
        fin = torch.isfinite(want[0])
        tol = 0 if dtype == torch.int8 else 1e-3
        assert (got[0][fin] - want[0][fin]).abs().max().item() <= tol
        assert (got[1][fin] < n_local).all()
