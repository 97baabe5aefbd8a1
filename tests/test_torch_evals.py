"""The port's evaluators (``qst_tpu_torch/evals``) against qst_tpu's.

The encoders are the tiny preset at float32 with qst_tpu's ``init_params``
carried into the port by ``state_dict_from_flax_params``; the JAX side runs
its fused loss (K3) in interpret mode, as its own tests do. Tolerances:
``ir_metrics`` exactly equal (a copy); the IR evaluator, fed the same
embeddings, every metric within 1e-6 and rankings equal up to ties (scores
within 1e-6); quadruplet accuracies equal; the validation loss within 1e-5
relative (each package's own encoder: embeddings agree to 1e-5).
"""

import ast
import csv
import dataclasses
import importlib
import inspect
import json
import os
import textwrap

import jax
import numpy as np
import pytest
import torch

from helpers import make_instances
from qst_tpu.core import config as jc
from qst_tpu.data.collate import QuadrupletCollator as JaxCollator
from qst_tpu.evals import eval_set as jeval_set
from qst_tpu.evals import factory as jfactory
from qst_tpu.evals import sequential as jsequential
from qst_tpu.evals.ir_evaluator import InformationRetrievalEvaluator as JaxIREvaluator
from qst_tpu.evals.loss_evaluator import QuadrupletLossEvaluator as JaxLossEvaluator
from qst_tpu.evals.quadruplet_evaluator import QuadrupletEvaluator as JaxQuadEvaluator
from qst_tpu.models.sentence_encoder import SentenceEncoder as JaxSentenceEncoder
from qst_tpu.models.sentence_encoder import init_params as jax_init_params
from qst_tpu.models.tokenizer import HashTokenizer as JaxHashTokenizer
from qst_tpu.retrieval.index import ExactIndex as JaxExactIndex
from qst_tpu_torch import evals as tevals
from qst_tpu_torch.core import config as tc
from qst_tpu_torch.data.collate import QuadrupletCollator
from qst_tpu_torch.evals import eval_set as teval_set
from qst_tpu_torch.evals import sequential as tsequential
from qst_tpu_torch.models.hf_import import state_dict_from_flax_params
from qst_tpu_torch.models.sentence_encoder import SentenceEncoder, SentenceEncoderModule
from qst_tpu_torch.models.tokenizer import HashTokenizer
from qst_tpu_torch.retrieval.index import ExactIndex

# the packages' ``ir_metrics`` names the function; the modules by path
jmetrics = importlib.import_module("qst_tpu.evals.ir_metrics")
tmetrics = importlib.import_module("qst_tpu_torch.evals.ir_metrics")
WORDS = [f"w{i}" for i in range(300)]


def _texts(n, seed):
    rng = np.random.default_rng(seed)
    return [" ".join(WORDS[j] for j in rng.integers(0, len(WORDS), int(rng.integers(4, 21))))
            for _ in range(n)]


@pytest.fixture(scope="module")
def encoders():
    """(JAX encoder, port encoder on the CPU, the port's model, configs)
    over the same tiny-preset weights."""
    jcfg = jc.EncoderConfig.tiny()
    params = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.key(3)))
    tcfg = tc.EncoderConfig(**dataclasses.asdict(jcfg))
    sd = state_dict_from_flax_params(params, tcfg)
    jenc = JaxSentenceEncoder(jcfg, params, JaxHashTokenizer(jcfg.vocab_size))
    tenc = SentenceEncoder(tcfg, sd, HashTokenizer(tcfg.vocab_size))
    model = SentenceEncoderModule(tcfg)
    model.load_state_dict(sd)
    return jenc, tenc, model, params, jcfg, tcfg


def _source_body(module) -> str:
    """A module's code without its docstrings, for comparing copies."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(module)))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("jmod,tmod", [(jmetrics, tmetrics), (jsequential, tsequential)])
def test_host_copies_are_the_source_code(jmod, tmod):
    assert _source_body(tmod) == _source_body(jmod)


def test_eval_set_is_the_source_code_but_for_its_imports():
    def body(module):
        return _source_body(module).replace("qst_tpu_torch", "qst_tpu")
    assert body(teval_set) == body(jeval_set)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ir_metrics_equal_the_source_on_random_rankings(seed):
    rng = np.random.default_rng(seed)
    ranked = [[f"d{j}" for j in rng.permutation(300)[:int(rng.integers(5, 250))]]
              for _ in range(40)]
    relevant = [{f"d{j}" for j in rng.choice(300, int(rng.integers(0, 12)), replace=False)}
                for _ in range(40)]
    grid = dataclasses.asdict(jc.IREvalConfig())
    kw = {k: grid[k] for k in ("accuracy_at_k", "precision_recall_at_k", "mrr_at_k",
                               "ndcg_at_k", "map_at_k")}
    want = jmetrics.ir_metrics(ranked, relevant, **kw)
    got = tmetrics.ir_metrics(ranked, relevant, **kw)
    assert got == want and len(got) == 44
    sp, so = rng.random(50), rng.random(50)
    assert tmetrics.triplet_accuracy(sp, so) == jmetrics.triplet_accuracy(sp, so)
    assert (tmetrics.quadruplet_global_accuracy(0.1, 0.7, 0.4, 0.6)
            == jmetrics.quadruplet_global_accuracy(0.1, 0.7, 0.4, 0.6))
    assert tmetrics.ir_metrics([], []) == jmetrics.ir_metrics([], [])


def _ir_problem():
    """64 queries × 512 docs, each query with 1-8 relevant docs."""
    rng = np.random.default_rng(9)
    queries = dict(zip([f"q{i}" for i in range(64)], _texts(64, 1)))
    corpus = dict(zip([f"d{i}" for i in range(512)], _texts(512, 2)))
    relevant = {q: {f"d{j}" for j in rng.choice(512, int(rng.integers(1, 9)), replace=False)}
                for q in queries}
    return queries, corpus, relevant


def _rows_equal_up_to_ties(ids_a, ids_b, scores, tol):
    """Ranked id lists that differ only where the two ids' scores tie."""
    for row_a, row_b, s in zip(ids_a, ids_b, scores):
        assert len(row_a) == len(row_b)
        for a, b in zip(row_a, row_b):
            if a != b:
                assert abs(s[a] - s[b]) <= tol, (a, b, s[a], s[b])


def test_ir_evaluator_matches_jax_on_the_same_embeddings(encoders, tmp_path):
    jenc, _, _, _, _, _ = encoders
    queries, corpus, relevant = _ir_problem()
    table = {}
    texts = list(queries.values()) + list(corpus.values())
    for t, e in zip(texts, jenc.encode(texts)):
        table[t] = e
    encode = lambda ts: np.stack([table[t] for t in ts])  # noqa: E731
    jev = JaxIREvaluator(queries, corpus, relevant, log_dir=str(tmp_path / "j"))
    tev = tevals.InformationRetrievalEvaluator(queries, corpus, relevant,
                                               log_dir=str(tmp_path / "t"), device="cpu")
    assert tev(encode, 0, 5) == pytest.approx(jev(encode, 0, 5), abs=1e-6)
    assert list(tev.last_results) == ["cos_sim", "dot_score", "euclid_score"]
    for score, metrics in jev.last_results.items():
        assert list(tev.last_results[score]) == list(metrics)
        for name, value in metrics.items():
            assert tev.last_results[score][name] == pytest.approx(value, abs=1e-6), (score, name)
    # the rankings behind them, up to ties
    q = encode(list(queries.values()))
    c = encode(list(corpus.values()))
    ids = list(corpus)
    for score in ("cos_sim", "dot_score", "euclid_score"):
        js, jids = JaxExactIndex(c, ids=ids).search_ids(q, k=512, score=score)
        ts, tids = ExactIndex(c, ids=ids, device="cpu").search_ids(q, k=512, score=score)
        np.testing.assert_allclose(ts, np.asarray(js), rtol=0, atol=1e-6)
        true = [dict(zip(row_ids, row_s)) for row_ids, row_s in zip(jids, np.asarray(js))]
        _rows_equal_up_to_ties(tids, jids, true, 1e-6)
    with open(tmp_path / "j" / "ir_results.csv") as fj, open(tmp_path / "t" / "ir_results.csv") as ft:
        jrows, trows = list(csv.reader(fj)), list(csv.reader(ft))
    assert [r[:4] for r in trows] == [r[:4] for r in jrows] and len(trows) == 1 + 3 * 44


def test_ir_evaluator_with_a_mesh_matches_jax_on_its_mesh(encoders, mesh8):
    """The evaluator's corpus index sharded over the port's mesh of eight
    CPU positions against qst_tpu's on its 8-device mesh, on the same
    embeddings: every metric within 1e-6; an index factory receives the
    mesh, and ``get_sequential_evaluator(mesh=)`` hands it to the IR
    evaluator. k stays within a shard's 128 rows: qst_tpu's sharded search
    fails past them."""
    from qst_tpu_torch.core.meshes import make_mesh

    jenc, _, _, _, _, tcfg = encoders
    grid = dict(accuracy_at_k=(1, 3), precision_recall_at_k=(1, 3), mrr_at_k=(10,),
                ndcg_at_k=(10,), map_at_k=(100,))
    tmesh = make_mesh(4, 2, devices=["cpu"] * 8)
    queries, corpus, relevant = _ir_problem()
    texts = list(queries.values()) + list(corpus.values())
    table = dict(zip(texts, jenc.encode(texts)))
    encode = lambda ts: np.stack([table[t] for t in ts])  # noqa: E731
    jev = JaxIREvaluator(queries, corpus, relevant, cfg=jc.IREvalConfig(**grid), mesh=mesh8)
    seen = []

    def factory(emb, ids, mesh):
        seen.append(mesh)
        return ExactIndex(emb, ids=ids, mesh=mesh)

    for kw in ({}, {"index_factory": factory}):
        tev = tevals.InformationRetrievalEvaluator(queries, corpus, relevant,
                                                   cfg=tc.IREvalConfig(**grid), mesh=tmesh, **kw)
        assert tev(encode) == pytest.approx(jev(encode), abs=1e-6)
        for score, metrics in jev.last_results.items():
            for name, value in metrics.items():
                assert tev.last_results[score][name] == pytest.approx(value, abs=1e-6), (
                    score, name)
    assert seen == [tmesh]
    iset = teval_set.create_ir_evaluation_set(make_instances(12), n_queries=4)
    seq = tevals.get_sequential_evaluator(tcfg, tc.LossConfig(), HashTokenizer(64), [],
                                          ir_eval_set=iset, mesh=tmesh, main="ir")
    assert dict(seq.evaluators)["ir"].mesh is tmesh


def test_ir_evaluator_keeps_the_embeddings_on_the_encoder_device(encoders):
    """With ``SentenceEncoder.encode`` the corpus index is built from the
    encoder's tensor where it lies (no host round trip), and a cached index
    is reused."""
    _, tenc, _, _, _, _ = encoders
    queries, corpus, relevant = _ir_problem()
    built = []

    def factory(emb, ids, mesh):
        built.append(emb)
        return ExactIndex(emb, ids=ids)

    ev = tevals.InformationRetrievalEvaluator(queries, corpus, relevant, index_factory=factory,
                                              cache_corpus_index=True)
    first = ev(tenc.encode)
    assert ev(tenc.encode) == first and len(built) == 1
    assert isinstance(built[0], torch.Tensor) and built[0].shape == (512, 64)


def test_quadruplet_evaluator_gives_equal_accuracies(encoders, tmp_path):
    jenc, tenc, _, _, _, _ = encoders
    insts = make_instances(48)
    for inst in insts:
        inst["negative"] = [make_instances(1, offset=inst["id"] + 7)[0]["reference"], "w1 w2"]
    jev = JaxQuadEvaluator.from_instances(insts, log_dir=str(tmp_path / "j"))
    tev = tevals.QuadrupletEvaluator.from_instances(insts, log_dir=str(tmp_path / "t"))
    assert (tev.anchors, tev.negatives) == (jev.anchors, jev.negatives)
    for call in range(2):
        want = jev(lambda ts: jenc.encode(list(ts)), 0, call)
        got = tev(tenc.encode, 0, call)
        assert got == want and tev.last_scores == jev.last_scores
    assert 0.0 < jev.last_scores["acc_part_neg"] < 1.0     # not a trivial case
    jrows = (tmp_path / "j" / "quadruplet_results.csv").read_text()
    assert (tmp_path / "t" / "quadruplet_results.csv").read_text() == jrows


def test_quadruplet_evaluator_resamples_like_the_source(encoders):
    _, tenc, _, _, _, _ = encoders
    draws = iter(range(100))

    def resampler():
        i = next(draws)
        return ([f"a{i}"], [f"p{i}"], [f"t{i}"], [f"n{i}"])

    tev = tevals.QuadrupletEvaluator(["a"], ["p"], ["t"], ["n"], resampler=resampler,
                                     reset_every=2)
    jev = JaxQuadEvaluator(["a"], ["p"], ["t"], ["n"], resampler=resampler, reset_every=2)
    seen_t, seen_j = [], []
    for _ in range(5):
        tev(tenc.encode)
        seen_t.append(tev.anchors[0])
    draws = iter(range(100))
    for _ in range(5):
        jev(lambda ts: tenc.encode(list(ts)))
        seen_j.append(jev.anchors[0])
    assert seen_t == seen_j == ["a", "a", "a0", "a0", "a1"]


def _val_batches(bs=6, n=18):
    insts = make_instances(n)
    for inst in insts:
        inst["negative"] = [make_instances(1, offset=inst["id"] + 5)[0]["positive"][0]]
    return [insts[s:s + bs] for s in range(0, n, bs)], insts


@pytest.mark.parametrize("fused", [False, True], ids=["plain-loss", "fused-loss"])
def test_loss_evaluator_matches_jax(encoders, fused, tmp_path):
    _, _, model, params, jcfg, tcfg = encoders
    batches, _ = _val_batches()
    jl = jc.LossConfig(use_fused_kernel=fused)
    tl = tc.LossConfig(use_fused_kernel=fused)
    jev = JaxLossEvaluator(jcfg, jl, batches, JaxCollator(JaxHashTokenizer(jcfg.vocab_size),
                                                          max_length=jcfg.max_seq_length),
                           log_dir=str(tmp_path / "j"))
    tev = tevals.QuadrupletLossEvaluator(tcfg, tl, batches,
                                         QuadrupletCollator(HashTokenizer(tcfg.vocab_size),
                                                            max_length=tcfg.max_seq_length),
                                         log_dir=str(tmp_path / "t"))
    want, got = jev(params, 1, 7), tev(model, 1, 7)
    assert got < 0 and got == pytest.approx(want, rel=1e-5)
    [jlog] = json.loads((tmp_path / "j" / "val_quadruplet_loss_eval.json").read_text())
    [tlog] = json.loads((tmp_path / "t" / "val_quadruplet_loss_eval.json").read_text())
    assert tlog.keys() == jlog.keys() and (tlog["epoch"], tlog["steps"]) == (1, 7)
    assert tlog["average_loss"] == pytest.approx(jlog["average_loss"], rel=1e-5)


def test_factory_main_score_order_and_logs_match_jax(encoders, tmp_path):
    """IR + quadruplet + loss through ``get_sequential_evaluator``: the same
    evaluator order, main score (the negated loss, last) and log rows; the
    training model's mode, weights and gradients untouched."""
    _, _, model, params, jcfg, tcfg = encoders
    batches, insts = _val_batches()
    insts_all = make_instances(30)
    jset = jeval_set.create_ir_evaluation_set(insts_all, n_queries=10, seed=4)
    tset = teval_set.create_ir_evaluation_set(insts_all, n_queries=10, seed=4)
    grid = dict(accuracy_at_k=(1, 3), precision_recall_at_k=(1, 3), mrr_at_k=(10,),
                ndcg_at_k=(10,), map_at_k=(20,), score_functions=("cos_sim", "dot_score"))
    jev = jfactory.get_sequential_evaluator(
        jcfg, jc.LossConfig(), JaxHashTokenizer(jcfg.vocab_size), insts, val_batches=batches,
        ir_eval_set=jset, ir_cfg=jc.IREvalConfig(**grid), log_dir=str(tmp_path / "j"))
    tev = tevals.get_sequential_evaluator(
        tcfg, tc.LossConfig(), HashTokenizer(tcfg.vocab_size), insts, val_batches=batches,
        ir_eval_set=tset, ir_cfg=tc.IREvalConfig(**grid), log_dir=str(tmp_path / "t"))
    assert [k for k, _ in tev.evaluators] == [k for k, _ in jev.evaluators] == [
        "ir", "quadruplet", "loss"]
    model.train()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for epoch, steps in ((-1, -1), (0, 3)):
        want, got = jev(params, epoch, steps), tev(model, epoch, steps)
        assert got == pytest.approx(want, rel=1e-5)
    assert model.training and all(p.grad is None for p in model.parameters())
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    for name in ("ir_results.csv", "quadruplet_results.csv"):
        jrows = list(csv.reader(open(tmp_path / "j" / name)))
        trows = list(csv.reader(open(tmp_path / "t" / name)))
        assert len(trows) == len(jrows) > 1
        for tr, jr in zip(trows[1:], jrows[1:]):
            keys = 4 if name == "ir_results.csv" else 2
            assert tr[:keys] == jr[:keys]
            np.testing.assert_allclose([float(v) for v in tr[keys:]],
                                       [float(v) for v in jr[keys:]], atol=1e-6)
    jl = json.loads((tmp_path / "j" / "val_quadruplet_loss_eval.json").read_text())
    tl = json.loads((tmp_path / "t" / "val_quadruplet_loss_eval.json").read_text())
    assert [(e["epoch"], e["steps"]) for e in tl] == [(e["epoch"], e["steps"]) for e in jl]
    with pytest.raises(ValueError):
        tevals.get_sequential_evaluator(tcfg, tc.LossConfig(), HashTokenizer(64), [])


@pytest.mark.parametrize("main", ["ir", "quadruplet"])
def test_factory_puts_the_main_evaluator_last(encoders, main):
    _, _, _, _, jcfg, tcfg = encoders
    batches, insts = _val_batches()
    iset = teval_set.create_ir_evaluation_set(make_instances(12), n_queries=4)
    jset = jeval_set.create_ir_evaluation_set(make_instances(12), n_queries=4)
    t = tevals.get_sequential_evaluator(tcfg, tc.LossConfig(), HashTokenizer(64), insts,
                                        val_batches=batches, ir_eval_set=iset, main=main)
    j = jfactory.get_sequential_evaluator(jcfg, jc.LossConfig(), JaxHashTokenizer(64), insts,
                                          val_batches=batches, ir_eval_set=jset, main=main)
    assert [k for k, _ in t.evaluators] == [k for k, _ in j.evaluators]
    assert t.evaluators[-1][0] == main


def test_eval_set_matches_jax_and_caches_read_across(tmp_path):
    insts = make_instances(40)
    kw = dict(n_queries=12, seed=5)
    for flags in (dict(), dict(use_pos_examples=False), dict(use_part_pos_examples=False)):
        want = jeval_set.create_ir_evaluation_set(insts, **kw, **flags)
        got = teval_set.create_ir_evaluation_set(insts, **kw, **flags)
        assert got.to_json() == want.to_json() and got.stats() == want.stats()
    hook = lambda pairs: np.array([0.9 if "cat" in d else 0.1 for _, d in pairs])  # noqa: E731
    want = jeval_set.create_ir_evaluation_set(insts, **kw, cross_encoder_predict=hook,
                                              query_variation_fn=str.upper)
    got = teval_set.create_ir_evaluation_set(insts, **kw, cross_encoder_predict=hook,
                                             query_variation_fn=str.upper)
    assert got.to_json() == want.to_json()
    # a cache written by either package reads in the other
    for writer, reader in ((jeval_set, teval_set), (teval_set, jeval_set)):
        path = str(tmp_path / f"{writer.__name__}.json")
        written = writer.create_ir_evaluation_set(insts, **kw, cache_path=path)
        read = reader.create_ir_evaluation_set([], **kw, cache_path=path)
        assert read.to_json() == written.to_json()
        with open(path) as f:
            assert json.load(f)["seed"] == 5


def test_evals_all_matches_the_source():
    import qst_tpu.evals as jevals

    assert tevals.__all__ == jevals.__all__
    assert all(hasattr(tevals, name) for name in tevals.__all__)
    assert os.path.basename(tevals.__file__) == "__init__.py"
