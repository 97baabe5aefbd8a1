"""The port's IVF index and K6 (the probed-cell scorer) against qst_tpu.

Inputs are made with numpy from a seed and fed to both packages; the Pallas
cell scorer runs with ``interpret=True`` on the JAX side, and K6's plain
version on the port's side (CPU tensors). Tolerances: scores rtol 1e-5 /
atol 1e-6 (the same products, f32 sums in another order — the tolerance of
``tests/test_ivf.py``'s own pallas-against-xla check); ids equal up to ties
(``lax.top_k`` and ``torch.topk`` order equal scores differently); ``None``
tails in the same places. k-means centroids agree to 1e-6 at f32 and 1e-4
with bf16 operands (XLA's CPU bf16 product sums in another order). An index
is carried across with ``IVFIndex.from_arrays``: the port's own build draws
its k-means init from a ``torch.Generator`` and is held to recall instead.
The CUDA kernel runs only on a GPU (``cuda`` marker; skipped here).
"""

import ast
import inspect
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qst_tpu.ops.ivf_pallas import ivf_cell_scores_fn
from qst_tpu.retrieval import index as jindex
from qst_tpu.retrieval import ivf as jivf
from qst_tpu_torch.ops import ivf as tops
from qst_tpu_torch.ops.distances import l2_normalize
from qst_tpu_torch.retrieval import ExactIndex, IVFIndex
from qst_tpu_torch.retrieval import index as tindex
from qst_tpu_torch.retrieval import ivf as tivf

TOL = dict(rtol=1e-5, atol=1e-6)
DTYPES = ["float32", "bfloat16"]


def _blobs():
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((16, 32)) * 4
    return np.concatenate([
        centers[i] + rng.standard_normal((64, 32)) * 0.3 for i in range(16)
    ]).astype(np.float32)


@pytest.fixture(scope="module")
def clustered_corpus():
    """1,024 docs in 16 planted blobs (as tests/test_ivf.py)."""
    return _blobs()


@pytest.fixture(scope="module")
def random_corpus():
    """1,000 unclustered docs: uneven cells, so a tight budget spills."""
    return np.random.default_rng(2).standard_normal((1000, 16)).astype(np.float32)


def _carry(jidx, dtype="float32"):
    """A JAX-built index as the port's, through from_arrays (bf16 cells
    travel as f32 numpy + the dtype name, as the saved artifact does)."""
    return IVFIndex.from_arrays(
        np.asarray(jidx.centroids), np.asarray(jidx.cells, np.float32),
        np.asarray(jidx.cell_ids), np.asarray(jidx.fill), ids=list(jidx.ids),
        default_n_probe=jidx.default_n_probe, dtype=dtype, device="cpu")


def assert_ivf_rows_equal(got, want):
    """Scores within TOL row by row (−inf where the probed cells ran out),
    ``None`` tails in the same places, ids equal except where equal scores
    let the two top-k orders (or the k-th slot) differ."""
    (s_a, i_a), (s_b, i_b) = got, want
    s_a, s_b = np.asarray(s_a, np.float64), np.asarray(s_b, np.float64)
    assert s_a.shape == s_b.shape
    np.testing.assert_array_equal(np.isneginf(s_a), np.isneginf(s_b))
    fin = np.isfinite(s_b)
    np.testing.assert_allclose(s_a[fin], s_b[fin], **TOL)
    for row in range(s_a.shape[0]):
        assert [i is None for i in i_a[row]] == [i is None for i in i_b[row]], row
        assert [i is None for i in i_a[row]] == list(np.isneginf(s_a[row])), row
        real = s_b[row][fin[row]]
        if not real.size:
            continue
        tie = TOL["rtol"] * np.abs(real).max() + TOL["atol"]
        kth = min(s_a[row][fin[row]].min(), real.min())
        sure_a = {i for i, s in zip(i_a[row], s_a[row]) if s > kth + tie}
        sure_b = {i for i, s in zip(i_b[row], s_b[row]) if s > kth + tie}
        assert sure_a <= set(i_b[row]) and sure_b <= set(i_a[row]), row


# ----------------------------------------------------------------- K6's plain
@pytest.mark.parametrize("dtype", DTYPES)
def test_cell_scores_plain_matches_pallas_interpret(dtype):
    rng = np.random.default_rng(3)
    C, L, D, Q, P = 6, 128, 32, 11, 3
    cells = rng.standard_normal((C, L, D)).astype(np.float32)
    cells[2, 100:] = 0                      # padded slots score 0, unmasked
    queries = rng.standard_normal((Q, D)).astype(np.float32)
    probe = rng.integers(0, C, (Q, P)).astype(np.int32)
    probe[0] = (0, C - 1, 0)                # first and last cell, a repeat
    want = np.asarray(ivf_cell_scores_fn(interpret=True)(
        jnp.asarray(queries), jnp.asarray(cells).astype(jnp.dtype(dtype)), jnp.asarray(probe)))
    tcells = torch.from_numpy(cells).to(getattr(torch, dtype))
    got = tops.ivf_cell_scores_plain(torch.from_numpy(queries), tcells, torch.from_numpy(probe))
    assert got.shape == (Q, P * L) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    before = tops.ivf_cell_scores.launches
    via = tops.ivf_cell_scores(torch.from_numpy(queries), tcells, torch.from_numpy(probe).long())
    assert torch.equal(via, got)            # CPU tensors take the plain version …
    assert tops.ivf_cell_scores.launches == before     # … and launch nothing


def test_cell_scores_plain_chunks_and_takes_any_budget(monkeypatch):
    """The query chunking of the plain version changes nothing, and L need
    not be a multiple of 128 (the TPU kernel's rule) or of 8."""
    rng = np.random.default_rng(4)
    cells = torch.from_numpy(rng.standard_normal((5, 20, 8)).astype(np.float32))
    queries = torch.from_numpy(rng.standard_normal((9, 8)).astype(np.float32))
    probe = torch.from_numpy(rng.integers(0, 5, (9, 2)))
    whole = tops.ivf_cell_scores_plain(queries, cells, probe)
    want = torch.einsum("qd,qpld->qpl", queries, cells[probe]).reshape(9, 40)
    np.testing.assert_allclose(whole.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    monkeypatch.setattr(tops, "_PLAIN_GATHER_BYTES", 1)      # one query per chunk
    assert torch.equal(tops.ivf_cell_scores_plain(queries, cells, probe), whole)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cell_scores_plain_with_fill_matches_jax_masking(dtype):
    """With ``fill`` the scorer gives what the JAX search makes of its
    kernel's scores (``where(slot < fill[probe], scores, -inf)``,
    qst_tpu/retrieval/ivf.py), for cells of 0, 1, L − 1 and L rows."""
    rng = np.random.default_rng(13)
    C, L, D, Q, P = 6, 128, 32, 9, 4
    cells = rng.standard_normal((C, L, D)).astype(np.float32)
    fill = np.array([0, 1, L - 1, L, 77, 128], np.int32)
    queries = rng.standard_normal((Q, D)).astype(np.float32)
    probe = rng.integers(0, C, (Q, P)).astype(np.int32)
    probe[0] = (0, 1, 2, 3)                 # every planted fill is probed …
    probe[1] = (3, 3, 0, 0)                 # … and two cells twice by one query
    raw = ivf_cell_scores_fn(interpret=True)(
        jnp.asarray(queries), jnp.asarray(cells).astype(jnp.dtype(dtype)), jnp.asarray(probe))
    live = jnp.arange(L)[None, None, :] < jnp.asarray(fill)[jnp.asarray(probe)][:, :, None]
    want = np.asarray(jnp.where(live.reshape(Q, P * L), raw, -jnp.inf))
    tcells = torch.from_numpy(cells).to(getattr(torch, dtype))
    args = (torch.from_numpy(queries), tcells, torch.from_numpy(probe))
    for counts in (torch.from_numpy(fill), torch.from_numpy(fill).long()):
        got = tops.ivf_cell_scores_plain(*args, counts).numpy()
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], **TOL)
        assert torch.equal(tops.ivf_cell_scores(*args, counts), torch.from_numpy(got))
    assert np.isneginf(got[0, :L]).all() and np.isfinite(got[0, 3 * L:]).all()
    assert np.isneginf(got[0, L + 1:2 * L]).all() and np.isfinite(got[0, L])
    # no fill: every slot's raw score, as the kernel alone gives it
    np.testing.assert_allclose(tops.ivf_cell_scores_plain(*args).numpy(), np.asarray(raw), **TOL)
    with pytest.raises(ValueError, match="fill must be"):
        tops.ivf_cell_scores(*args, torch.zeros(C + 1, dtype=torch.int32))
    with pytest.raises(TypeError, match="fill must hold"):
        tops.ivf_cell_scores(*args, torch.zeros(C))


@pytest.mark.parametrize("shape,n_cells", [((8, 8), 1024), ((256, 8), 1024), ((5, 3), 2),
                                           ((1, 1), 7)])
def test_group_pairs_by_cell_against_numpy(shape, n_cells):
    """Every pair once, the pairs of a cell neighbours, repeats and ids
    outside [0, C) kept (below 0 first, C and above last)."""
    rng = np.random.default_rng(14)
    probe = rng.integers(0, n_cells, shape).astype(np.int32)
    probe[0, 0] = -3                         # outside [0, C), both sides
    if probe.size > 2:
        probe[-1, -1] = n_cells + 5
        probe[0, -1] = probe[0, 1]           # one query probing a cell twice
    ids, order = tops._group_pairs_by_cell(torch.from_numpy(probe))
    ids, order = ids.numpy(), order.numpy()
    flat = probe.reshape(-1)
    assert ids.dtype == np.int32 and order.dtype == np.int64
    np.testing.assert_array_equal(np.sort(order), np.arange(flat.size))   # every pair once
    np.testing.assert_array_equal(ids, flat[order])      # position i holds pair order[i]'s cell
    np.testing.assert_array_equal(ids, np.sort(flat))    # ascending: a cell's pairs are one run
    assert ids[0] == -3 and (probe.size <= 2 or ids[-1] == n_cells + 5)


def test_cell_scores_validation():
    q, c = torch.zeros((3, 8)), torch.zeros((4, 16, 8))
    p = torch.zeros((3, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="expected"):
        tops.ivf_cell_scores(torch.zeros((3, 6)), c, p)
    with pytest.raises(ValueError, match="expected"):
        tops.ivf_cell_scores(q, c, torch.zeros((2, 2), dtype=torch.int32))
    with pytest.raises(TypeError, match="int32/int64"):
        tops.ivf_cell_scores(q, c, p.float())
    with pytest.raises(IndexError):         # the plain version raises on a bad id
        tops.ivf_cell_scores(q, c, p + 4)


@pytest.mark.parametrize("shape,k", [((5, 8192), 5), ((3, 640), 7), ((4, 4100), 3)])
def test_local_topk_matches_jax(shape, k):
    s = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    js, ji = jindex._local_topk(jnp.asarray(s), k)
    ts, ti = tindex._local_topk(torch.from_numpy(s), k)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


# ------------------------------------------------------------ build pieces
@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("corpus", ["clustered_corpus", "random_corpus"])
def test_lloyd_matches_jax_kmeans(request, corpus, compute_dtype):
    """The Lloyd loop from the JAX run's own initial rows: jax.random.choice
    with the key and shape of qst_tpu/retrieval/ivf.py:58."""
    data = request.getfixturevalue(corpus)
    n_clusters = 16 if corpus == "clustered_corpus" else 8
    key = jax.random.key(1)
    want_c, want_a = jivf.kmeans(jnp.asarray(data), key, n_clusters, n_iters=10,
                                 compute_dtype=compute_dtype)
    init = np.asarray(jax.random.choice(key, data.shape[0], (n_clusters,), replace=False))
    x = l2_normalize(torch.from_numpy(data.copy()))
    got_c, got_a = tivf.lloyd(x, x[torch.from_numpy(init.copy())], 10, compute_dtype)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0,
                               atol=1e-4 if compute_dtype else 1e-6)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))


def test_kmeans_partitions_and_is_seeded(clustered_corpus):
    data = torch.from_numpy(clustered_corpus.copy())
    c, assign = tivf.kmeans(data, torch.Generator().manual_seed(0), 16, n_iters=15)
    c2, _ = tivf.kmeans(data, torch.Generator().manual_seed(0), 16, n_iters=15)
    assert torch.equal(c, c2)
    np.testing.assert_allclose(c.norm(dim=1).numpy(), 1.0, atol=1e-6)
    assign = assign.numpy()
    agree = np.mean([(assign[i * 64:(i + 1) * 64]
                      == np.bincount(assign[i * 64:(i + 1) * 64]).argmax()).mean()
                     for i in range(16)])
    assert agree > 0.9      # docs of one planted blob mostly share a cluster


@pytest.mark.parametrize("dtype", DTYPES)
def test_assign_choices_matches_jax(random_corpus, dtype):
    cents = l2_normalize(torch.from_numpy(
        np.random.default_rng(6).standard_normal((8, 16)).astype(np.float32)))
    want = jivf._assign_choices(jnp.asarray(random_corpus).astype(jnp.dtype(dtype)),
                                jnp.asarray(cents.numpy()), 4)
    got = tivf._assign_choices(torch.from_numpy(random_corpus.copy()).to(getattr(torch, dtype)),
                               cents, 4)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _ast_without_docstrings(obj) -> str:
    tree = ast.parse(textwrap.dedent(inspect.getsource(obj)))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


def test_fill_cells_is_the_source_copy():
    assert _ast_without_docstrings(tivf._fill_cells) == _ast_without_docstrings(jivf._fill_cells)
    rng = np.random.default_rng(7)
    for n, c, r, budget in ((500, 8, 4, 70), (300, 16, 2, 24), (64, 4, 4, 16)):
        skew = 1.0 / (1 + np.arange(c))        # crowded first cells: spills, stragglers
        choices = np.stack([rng.choice(c, r, replace=False, p=skew / skew.sum())
                            for _ in range(n)]).astype(np.int32)
        want, got = jivf._fill_cells(choices, c, budget), tivf._fill_cells(choices, c, budget)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2] and got[2] > 0          # every case spills
    with pytest.raises(RuntimeError, match="cell budget"):
        tivf._fill_cells(choices, 4, 8)


# ------------------------------------------------- a JAX index carried over
CARRIED = [("clustered", "float32"), ("clustered", "bfloat16"), ("spill", "float32")]


@pytest.fixture(scope="module")
def carried(clustered_corpus, random_corpus):
    """JAX-built indexes and their port copies. "spill" has a tight hand-set
    budget (136: a multiple of 8, not of 128) whose cells overflow."""
    out = {}
    for name, dtype in CARRIED:
        if name == "clustered":
            jidx = jivf.IVFIndex(clustered_corpus, n_clusters=16, seed=0, dtype=dtype)
        else:
            jidx = jivf.IVFIndex(random_corpus, n_clusters=8, seed=0, cell_budget=136,
                                 spill_rounds=8)
            assert jidx.spilled > 0 and jidx.cell_budget == 136
        out[name, dtype] = (jidx, _carry(jidx, dtype))
    return out


@pytest.mark.parametrize("n_probe", [2, 4, 99])
@pytest.mark.parametrize("name,dtype", CARRIED)
def test_carried_index_search_matches_jax(carried, name, dtype, n_probe):
    """Both of the port's backends against the JAX index's "xla" and, where
    the budget allows it, "pallas" (interpret) searches; k = 150 at
    n_probe = 2 over 64-doc blobs leaves ``None`` tails."""
    jidx, tidx = carried[name, dtype]
    assert tidx.cells.dtype == getattr(torch, dtype)
    assert tidx.n_docs == jidx.n_docs and tidx.cell_budget == jidx.cell_budget
    queries = np.random.default_rng(8).standard_normal(
        (11, jidx.cells.shape[-1])).astype(np.float32)
    for k in (7, 150):
        want = jidx.search(queries, k=k, n_probe=n_probe, backend="xla")
        if k == 150 and n_probe == 2 and name == "clustered":
            assert any(i is None for row in want[1] for i in row)
        for backend in ("xla", "pallas"):
            got = tidx.search(queries, k=k, n_probe=n_probe, backend=backend)
            assert_ivf_rows_equal(got, want)
        if jidx.cell_budget % 128 == 0:
            assert_ivf_rows_equal(
                tidx.search(queries, k=k, n_probe=n_probe, backend="pallas"),
                jidx.search(queries, k=k, n_probe=n_probe, backend="pallas"))


def test_carried_index_rows_chunks_and_tuning(carried):
    jidx, tidx = carried["clustered", "float32"]
    np.testing.assert_array_equal(tidx.reconstruct_rows(), jidx.reconstruct_rows())
    for backend, n_probe in (("xla", 4), ("pallas", 4), ("pallas", 16)):
        assert tidx._q_chunk(backend, n_probe) == jidx._q_chunk(backend, n_probe)
    assert not tidx._pallas_eligible()       # a CPU index scans under "auto"
    rng = np.random.default_rng(3)
    queries = _blobs()[rng.choice(1024, 24)] + rng.standard_normal((24, 32)).astype(
        np.float32) * 0.1
    want = jidx.tune_n_probe(queries, k=10, target_recall=0.9, set_default=False)
    got = tidx.tune_n_probe(queries, k=10, target_recall=0.9)
    assert got[0] == want[0] and got[1] == pytest.approx(want[1])
    assert tidx.default_n_probe == got[0]
    s, ids = tidx.search_ids(queries[:3], k=4)
    assert_ivf_rows_equal((s, ids), tidx.search(queries[:3], k=4, n_probe=got[0]))
    with pytest.warns(UserWarning, match="exhaustive full probe"):
        best, curve = tidx.tune_n_probe(queries, k=10, target_recall=1.0, candidates=[1],
                                        set_default=False)
    assert best == 16 and curve[16] == 1.0 and tidx.default_n_probe == got[0]
    with pytest.raises(ValueError, match="target_recall"):
        tidx.tune_n_probe(queries, target_recall=0.0)
    with pytest.raises(ValueError, match="no candidates"):
        tidx.tune_n_probe(queries, candidates=[16, 99, 0])
    with pytest.raises(ValueError, match="non-empty"):
        tidx.tune_n_probe(np.zeros((0, 32), np.float32))


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_search_stream_matches_search(carried, backend):
    _, tidx = carried["spill", "float32"]
    rng = np.random.default_rng(9)
    batches = [rng.standard_normal((5, 16)).astype(np.float32) for _ in range(4)]
    got = list(tidx.search_stream(iter(batches), k=3, n_probe=4, depth=2, backend=backend))
    assert len(got) == 4
    for q, (s, ids) in zip(batches, got):
        es, eids = tidx.search(q, k=3, n_probe=4, backend=backend)
        np.testing.assert_array_equal(s, es)
        assert ids == eids
    with pytest.raises(ValueError, match="depth"):
        list(tidx.search_stream(batches[:1], depth=0))


@pytest.mark.parametrize("name,dtype", CARRIED)
def test_compact_leaves_results_unchanged(carried, name, dtype):
    jidx, _ = carried[name, dtype]
    tidx = _carry(jidx, dtype)
    queries = np.random.default_rng(10).standard_normal(
        (7, tidx.cells.shape[-1])).astype(np.float32)
    before = tidx.search(queries, k=7, n_probe=5, backend="pallas")
    tidx.compact()
    assert tidx.cells.dtype == getattr(torch, dtype) and tidx.cells.is_contiguous()
    after = tidx.search(queries, k=7, n_probe=5, backend="pallas")
    np.testing.assert_array_equal(after[0], before[0])
    assert after[1] == before[1]


def test_validation_errors(clustered_corpus, carried):
    kw = dict(device="cpu")
    with pytest.raises(ValueError, match="n_clusters"):
        IVFIndex(clustered_corpus[:8], n_clusters=16, **kw)
    with pytest.raises(ValueError, match="ids length"):
        IVFIndex(clustered_corpus, n_clusters=4, ids=[1, 2], **kw)
    with pytest.raises(ValueError, match="train_sample"):
        IVFIndex(clustered_corpus, n_clusters=600, train_sample=512, **kw)
    with pytest.raises(ValueError, match="dtype"):
        IVFIndex(clustered_corpus, n_clusters=4, dtype="int8", **kw)
    with pytest.raises(TypeError, match="Mesh"):
        IVFIndex(clustered_corpus, n_clusters=4, mesh=object(), **kw)
    with pytest.raises(RuntimeError, match="cell budget"):
        IVFIndex(clustered_corpus, n_clusters=16, cell_budget=8, spill_rounds=2, **kw)
    _, tidx = carried["clustered", "float32"]
    with pytest.raises(ValueError, match="backend"):
        tidx.search(clustered_corpus[:2], backend="nope")
    with pytest.raises(ValueError, match="cos_sim/dot_score"):
        tidx.search_ids(clustered_corpus[:2], score="euclid_score")
    with pytest.raises(ValueError, match="mismatch"):
        IVFIndex.from_arrays(np.zeros((2, 4)), np.zeros((2, 8, 4)), np.zeros((2, 7)),
                             np.zeros(2), **kw)
    with pytest.raises(TypeError, match="Mesh"):
        IVFIndex.from_arrays(np.zeros((2, 4)), np.zeros((2, 8, 4)), np.zeros((2, 8)),
                             np.zeros(2), mesh=object(), **kw)


# ------------------------------------------------------ a port-built index
def _recall(a, b, k):
    return np.mean([len(set(x) & set(y)) / k for x, y in zip(a, b)])


def test_port_built_index_drops_nothing_and_recalls(clustered_corpus):
    ivf = IVFIndex(clustered_corpus, n_clusters=16, seed=0, device="cpu")
    assert ivf.cell_budget % 128 == 0 and ivf.device.type == "cpu"
    stored = ivf.cell_ids.numpy().ravel()
    assert sorted(stored[stored >= 0]) == list(range(len(clustered_corpus)))
    np.testing.assert_array_equal(ivf.fill.numpy(), (ivf.cell_ids.numpy() >= 0).sum(axis=1))
    cn = clustered_corpus / np.linalg.norm(clustered_corpus, axis=1, keepdims=True)
    np.testing.assert_allclose(ivf.reconstruct_rows(), cn, rtol=1e-5, atol=1e-6)

    rng = np.random.default_rng(1)
    queries = clustered_corpus[rng.choice(len(clustered_corpus), 32)] \
        + rng.standard_normal((32, 32)).astype(np.float32) * 0.1
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    _, exact_ids = ExactIndex(clustered_corpus, normalize=True, device="cpu").search_ids(qn, k=10)
    for backend in ("xla", "pallas"):
        _, ids = ivf.search(queries, k=10, n_probe=4, backend=backend)
        assert _recall(exact_ids, ids, 10) > 0.9
        _, ids_all = ivf.search(queries, k=10, n_probe=16, backend=backend)
        assert _recall(exact_ids, ids_all, 10) > 0.999   # full probe is exact


def test_port_built_index_spills_samples_and_takes_tensors(clustered_corpus, random_corpus):
    tight = IVFIndex(clustered_corpus, n_clusters=16, cell_budget=70, spill_rounds=16,
                     seed=0, device="cpu")
    stored = tight.cell_ids.numpy().ravel()
    assert sorted(stored[stored >= 0]) == list(range(len(clustered_corpus)))
    assert tight.spilled > 0 and tight.cell_budget == 72      # rounded up to 8

    # a corpus larger than train_sample trains k-means on a sample
    sampled = IVFIndex(random_corpus, n_clusters=8, train_sample=256, seed=3, device="cpu",
                       ids=[f"d{i}" for i in range(1000)])
    assert sampled.n_docs == 1000 and int(sampled.fill.sum()) == 1000
    s, ids = sampled.search(random_corpus[:5], k=1, n_probe=8)
    assert [row[0] for row in ids] == [f"d{i}" for i in range(5)]
    np.testing.assert_allclose(s[:, 0], 1.0, atol=1e-5)

    # a tensor fixes the device, and builds the index of the host array
    host = IVFIndex(clustered_corpus, n_clusters=16, seed=0, device="cpu")
    dev = IVFIndex(torch.from_numpy(clustered_corpus.copy()), n_clusters=16, seed=0)
    q = np.random.default_rng(5).standard_normal((4, 32)).astype(np.float32)
    assert_ivf_rows_equal(dev.search(q, k=5), host.search(q, k=5))


def test_port_built_bf16_cells(clustered_corpus):
    pick = np.random.default_rng(4).choice(len(clustered_corpus), 16, replace=False)
    b16 = IVFIndex(clustered_corpus, n_clusters=16, seed=0, dtype="bfloat16", device="cpu")
    assert b16.cells.dtype == torch.bfloat16
    for backend in ("xla", "pallas"):
        _, ids = b16.search(clustered_corpus[pick], k=5, n_probe=4, backend=backend)
        assert (np.array([row[0] for row in ids]) == pick).mean() > 0.9


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_cell_scores_match_plain(cuda_device, dtype):
    """K6 against its plain version on the card: 1e-4 absolute on unit
    vectors (exact products, f32 sums in another order), a ragged cell
    budget (a multiple of 8 only), repeated probes and the first and last
    cell; an out-of-range id scores −inf."""
    gen = torch.Generator().manual_seed(11)
    C, L, D, P = 40, 136, 64, 5
    unit = torch.nn.functional.normalize
    cells = unit(torch.randn((C, L, D), generator=gen), dim=2).to(cuda_device,
                                                                  getattr(torch, dtype))
    for Q in (1, 11, 70):
        queries = unit(torch.randn((Q, D), generator=gen), dim=1).to(cuda_device)
        probe = torch.randint(0, C, (Q, P), generator=gen).to(cuda_device)
        probe[0, :3] = torch.tensor([0, C - 1, 0])
        before = tops.ivf_cell_scores.launches
        got = tops.ivf_cell_scores(queries, cells, probe)
        assert tops.ivf_cell_scores.launches == before + 1
        want = tops.ivf_cell_scores_plain(queries, cells, probe)
        torch.cuda.synchronize()
        assert got.shape == (Q, P * L)
        assert (got - want).abs().max().item() <= 1e-4
    probe[0, 1] = C
    got = tops.ivf_cell_scores(queries, cells, probe)
    assert torch.isneginf(got[0, L:2 * L]).all() and torch.isfinite(got[0, :L]).all()
    with pytest.raises(ValueError, match="one CUDA device"):
        tops.ivf_cell_scores(queries.cpu(), cells, probe)
    with pytest.raises(ValueError, match="D % 8"):
        tops.ivf_cell_scores(queries[:, :63], cells[:, :, :63].contiguous(), probe)


@pytest.mark.cuda
def test_cuda_index_backends_agree(cuda_device):
    """On a GPU index "auto" takes K6 (budget a multiple of 128) and agrees
    with the probe scan."""
    ivf = IVFIndex(torch.from_numpy(_blobs()).to(cuda_device), n_clusters=16, seed=0)
    assert ivf._pallas_eligible()
    q = np.random.default_rng(12).standard_normal((9, 32)).astype(np.float32)
    before = tops.ivf_cell_scores.launches
    auto = ivf.search(q, k=150, n_probe=2)
    assert tops.ivf_cell_scores.launches == before + 1
    assert_ivf_rows_equal(auto, ivf.search(q, k=150, n_probe=2, backend="xla"))



@pytest.mark.cuda
@pytest.mark.parametrize("Q", [1, 11, 256, 1100])
@pytest.mark.parametrize("L", [1152, 1160, 2048])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_cell_scores_both_forms_with_and_without_fill(cuda_device, monkeypatch, dtype, L, Q):
    """K6 on the card, pairs grouped by cell and a pair a block, with fill
    counts (an empty cell, one row, L − 1, L) and without: 1e-4 absolute
    against the plain version on unit vectors, −inf in the same places, and
    ids outside [0, C) scoring −inf."""
    gen = torch.Generator().manual_seed(15)
    C, D, P = 64, 384, 8
    unit = torch.nn.functional.normalize
    cells = unit(torch.randn((C, L, D), generator=gen), dim=2).to(cuda_device,
                                                                  getattr(torch, dtype))
    fill = torch.randint(0, L + 1, (C,), generator=gen, dtype=torch.int32)
    fill[:2], fill[-2:] = torch.tensor([0, 1]), torch.tensor([L - 1, L])
    fill = fill.to(cuda_device)
    queries = unit(torch.randn((Q, D), generator=gen), dim=1).to(cuda_device)
    probe = torch.randint(0, C, (Q, P), generator=gen, dtype=torch.int32)
    probe[0] = torch.tensor([0, C - 1, 0, C - 1, 1, C - 2, 1, C - 2])
    outside = torch.zeros((Q, P), dtype=torch.bool)
    if Q > 2:
        probe[1, 0], probe[1, 1], probe[2] = -1, C, C + 5
        outside[1, :2] = outside[2] = True
    probe, outside = probe.to(cuda_device), outside.to(cuda_device)
    for counts in (None, fill):
        want = tops.ivf_cell_scores_plain(queries, cells, probe.clamp(0, C - 1), counts)
        want = torch.where(outside.repeat_interleave(L, dim=1), float("-inf"), want)
        for line in (1, 1 << 62):           # grouped; a pair a block
            monkeypatch.setattr(tops, "_GROUP_MIN_PAIRS", line)
            before = tops.ivf_cell_scores.launches
            got = tops.ivf_cell_scores(queries, cells, probe, counts)
            torch.cuda.synchronize()
            assert tops.ivf_cell_scores.launches == before + 1
            assert got.shape == (Q, P * L) and not torch.isnan(got).any()
            assert torch.equal(torch.isneginf(got), torch.isneginf(want))
            assert torch.where(torch.isneginf(want), 0.0, got - want).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_cuda_compact_releases_the_old_buffers(cuda_device):
    """After searches through K6, ``compact()`` leaves one copy of the cells
    on the card, not two, and the answers are unchanged."""
    ivf = IVFIndex(torch.from_numpy(_blobs()).to(cuda_device), n_clusters=16, seed=0)
    q = np.random.default_rng(16).standard_normal((9, 32)).astype(np.float32)
    want = [ivf.search(q, k=5, n_probe=2, backend="pallas") for _ in range(3)][-1]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda_device)
    ivf.compact()
    torch.cuda.synchronize()
    assert ivf.cells.is_cuda and torch.cuda.memory_allocated(cuda_device) <= before
    assert_ivf_rows_equal(ivf.search(q, k=5, n_probe=2, backend="pallas"), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D", [("float32", 12288), ("float32", 3688), ("bfloat16", 24576),
                                     ("bfloat16", 7400)])
def test_cuda_cell_scores_wide_rows(cuda_device, monkeypatch, dtype, D):
    """Rows up to 48 KiB: past what two staged tiles hold, K6 takes fewer
    rows a tile and then a single stage; wider rows raise."""
    gen = torch.Generator().manual_seed(17)
    C, L, P, Q = 6, 24, 3, 5
    unit = torch.nn.functional.normalize
    cells = unit(torch.randn((C, L, D), generator=gen), dim=2).to(cuda_device,
                                                                  getattr(torch, dtype))
    fill = torch.tensor([0, 1, L - 1, L, 7, 16], dtype=torch.int32, device=cuda_device)
    queries = unit(torch.randn((Q, D), generator=gen), dim=1).to(cuda_device)
    probe = torch.randint(0, C, (Q, P), generator=gen).to(cuda_device)
    for counts in (None, fill):
        want = tops.ivf_cell_scores_plain(queries, cells, probe, counts)
        for line in (1, 1 << 62):           # grouped; a pair a block
            monkeypatch.setattr(tops, "_GROUP_MIN_PAIRS", line)
            got = tops.ivf_cell_scores(queries, cells, probe, counts)
            torch.cuda.synchronize()
            assert torch.equal(torch.isneginf(got), torch.isneginf(want))
            assert torch.where(torch.isneginf(want), 0.0, got - want).abs().max().item() <= 1e-4
    if D * cells.element_size() == 48 * 1024:
        wider = torch.zeros((2, 8, D + 8), dtype=cells.dtype, device=cuda_device)
        with pytest.raises(ValueError, match="bytes"):
            tops.ivf_cell_scores(torch.zeros((1, D + 8), device=cuda_device), wider,
                                 torch.zeros((1, 1), dtype=torch.int64, device=cuda_device))
