"""The port's CLIs (``index_main``, ``train_main``, ``ir_eval_main``) and
``cli/common.py`` against qst_tpu's.

The two packages draw different random weights from one seed, so the
encoder's weights are carried across: qst_tpu's ``init_params`` go through
``state_dict_from_flax_params`` into a ``torch.save`` best checkpoint that
the port's ``--model_path`` loads. The float32 index's answers are then held
to the JAX ``Retriever``'s over the same weights (scores to 1e-5: the two
encoders' embeddings agree to 1e-5; ids up to ties), and the IVF index's
answers at full probe to the exact ones; ``ir_eval_main``'s metrics over
the same carried weights to qst_tpu's evaluator. ``train_main`` is held to
what it must write: every evaluator at epoch −1 and each evaluation step,
qst_tpu's eval set, a best checkpoint. Every command runs with
``--device cpu``.
"""

import argparse
import csv
import dataclasses
import json
import os
import urllib.request

import jax
import numpy as np
import pytest
import torch

from qst_tpu.cli import common as jcommon
from qst_tpu.cli import index_main as jmain
from qst_tpu.cli import ir_eval_main as jir_main
from qst_tpu.cli import train_main as jtrain_main
from qst_tpu.core.config import EncoderConfig as JaxConfig
from qst_tpu.core.config import IREvalConfig as JaxIREvalConfig
from qst_tpu.data.chunks import ChunkStore as JaxChunkStore
from qst_tpu.evals import InformationRetrievalEvaluator as JaxIREvaluator
from qst_tpu.evals import create_ir_evaluation_set as jax_create_ir_evaluation_set
from qst_tpu.models.sentence_encoder import SentenceEncoder as JaxSentenceEncoder
from qst_tpu.models.sentence_encoder import init_params as jax_init_params
from qst_tpu.models.tokenizer import HashTokenizer as JaxHashTokenizer
from qst_tpu.retrieval import IVFPQIndex as JaxIVFPQIndex
from qst_tpu.retrieval import PQIndex as JaxPQIndex
from qst_tpu.retrieval import Retriever as JaxRetriever
from qst_tpu.retrieval.retriever import load_index as jax_load_index
from qst_tpu_torch.cli import common as tcommon
from qst_tpu_torch.cli import index_main as tmain
from qst_tpu_torch.cli import ir_eval_main as tir_main
from qst_tpu_torch.cli import train_main as ttrain_main
from qst_tpu_torch.core.config import EncoderConfig
from qst_tpu_torch.models.hf_import import state_dict_from_flax_params
from qst_tpu_torch.models.tokenizer import HashTokenizer
from qst_tpu_torch.train.checkpoints import _save
from test_torch_slice import assert_topk_equal_up_to_ties

TOPICS = ["cat", "dog", "pasta", "plane", "river"]
DOCS = [f"{TOPICS[i % 5]} doc number {i}" for i in range(400)]
QUERIES = ["a cat on a rug", "river doc number 9", "pasta plane"]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A docs file, and an experiment dir holding qst_tpu's tiny-preset
    weights as the port's best checkpoint."""
    root = tmp_path_factory.mktemp("cli")
    texts = str(root / "docs.txt")
    with open(texts, "w") as f:
        f.write("\n".join(DOCS) + "\n\n")            # a blank line is skipped
    jcfg = JaxConfig.tiny()
    params = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.key(5)))
    cfg = EncoderConfig(**dataclasses.asdict(jcfg))
    exp = str(root / "exp")
    _save(state_dict_from_flax_params(params, cfg),
          os.path.join(exp, "checkpoints", "best", "params.pt"))
    jenc = JaxSentenceEncoder(jcfg, params, JaxHashTokenizer(jcfg.vocab_size))
    return root, texts, exp, jenc


def _run(argv, capsys):
    assert tmain.main([*argv, "--encoder_preset", "tiny", "--device", "cpu"]) == 0
    return [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()
            if line.startswith("{")]


@pytest.fixture(scope="module")
def built(workdir):
    """Both index kinds built by the CLI from the carried weights."""
    root, texts, exp, _ = workdir
    dirs = {}
    for kind in ("float32", "ivf"):
        dirs[kind] = str(root / f"idx_{kind}")
        assert tmain.main(["build", "--texts", texts, "--index_dir", dirs[kind],
                           "--encoder_preset", "tiny", "--model_path", exp, "--index_dtype", kind,
                           "--ivf_clusters", "16", "--ivf_probe", "16", "--device", "cpu"]) == 0
    return dirs


@pytest.mark.parametrize("kind", ["float32", "ivf"])
def test_index_cli_build_and_query(workdir, built, kind, capsys):
    _, _, exp, jenc = workdir
    with open(os.path.join(built[kind], "index_meta.json")) as f:
        meta = json.load(f)
    assert meta["n_docs"] == 400 and meta.get("dtype", "float32") == kind
    if kind == "ivf":
        assert meta["n_probe"] == 16 and os.path.isfile(os.path.join(built[kind], "ivf_cells.npy"))
    with open(os.path.join(built[kind], "command_line_args.json")) as f:
        dumped = json.load(f)
    assert dumped["index_dtype"] == kind and dumped["device"] == "cpu"
    assert dumped["manual_notes"] == "" and dumped["ivf_clusters"] == 16

    out = _run(["query", "--index_dir", built[kind], "--model_path", exp, "--index_dtype", kind,
                "--k", "4", "--queries", *QUERIES], capsys)
    assert [o["query"] for o in out] == QUERIES and all(len(o["hits"]) == 4 for o in out)
    # the JAX Retriever over the same weights: an exact search, which the
    # IVF index reproduces at full probe (16 of 16 cells)
    want = JaxRetriever(jenc).build(DOCS).search(QUERIES, k=4, return_texts=True)
    for o, row in zip(out, want):
        np.testing.assert_allclose([h["score"] for h in o["hits"]], [r[1] for r in row],
                                   rtol=0, atol=1e-5 + 5e-5)      # scores print at 4 decimals
        assert all(h["text"] == DOCS[h["id"]] for h in o["hits"])
        kth = row[-1][1]
        sure = {r[0] for r in row if r[1] > kth + 1e-4}
        assert sure <= {h["id"] for h in o["hits"]}


def test_index_cli_default_ivf_probe_and_random_init(workdir, capsys):
    """Without --model_path the encoder is random from --seed (default 14),
    and the default probe count (8) persists in the metadata."""
    root, texts, _, _ = workdir
    idx = str(root / "idx_seeded")
    _run(["build", "--texts", texts, "--index_dir", idx, "--index_dtype", "ivf",
          "--ivf_clusters", "16"], capsys)
    with open(os.path.join(idx, "index_meta.json")) as f:
        assert json.load(f)["n_probe"] == 8
    a = _run(["query", "--index_dir", idx, "--index_dtype", "ivf", "--k", "2",
              "--queries", "a cat on a rug"], capsys)
    b = _run(["query", "--index_dir", idx, "--index_dtype", "ivf", "--k", "2",
              "--queries", "a cat on a rug", "--seed", "14"], capsys)
    assert a == b and len(a[0]["hits"]) == 2


def test_index_cli_input_errors(workdir):
    root, texts, _, _ = workdir
    base = ["--index_dir", str(root / "nope"), "--encoder_preset", "tiny", "--device", "cpu"]
    with pytest.raises(SystemExit, match="exactly one"):
        tmain.main(["build", *base])
    with pytest.raises(SystemExit, match="exactly one"):
        tmain.main(["build", "--texts", texts, "--dataset_root", "x", *base])
    empty = str(root / "empty.txt")
    open(empty, "w").close()
    with pytest.raises(SystemExit, match="no documents"):
        tmain.main(["build", "--texts", empty, *base])


@pytest.fixture(scope="module")
def built_compressed(workdir):
    """The pq (m 8), ivfpq (4 bits, 8 cells, all probed) and streaming
    indexes built by the CLI from the carried weights."""
    root, texts, exp, _ = workdir
    dirs = {}
    for kind in ("pq", "ivfpq", "streaming"):
        dirs[kind] = str(root / f"idx_{kind}")
        assert tmain.main(["build", "--texts", texts, "--index_dir", dirs[kind],
                           "--encoder_preset", "tiny", "--model_path", exp, "--index_dtype", kind,
                           "--pq_m", "8", "--ivf_clusters", "8", "--ivf_probe", "8",
                           "--ivfpq_bits", "4", "--device", "cpu"]) == 0
    return dirs


@pytest.mark.parametrize("command", ["build", "serve", "query"])
@pytest.mark.parametrize("kind", ["pq", "ivfpq", "streaming"])
def test_unported_index_kinds_exit_with_a_message(workdir, built_compressed, command, kind,
                                                  capsys):
    """The pq, ivfpq and streaming kinds through ``index_main`` with
    ``--device cpu``: ``build`` writes the JAX package's artifact, ``query``
    prints hits whose scores are the documents' cosines (pq and ivfpq
    re-rank from bf16 rows, and streaming sends bf16 rows: 1e-2), the
    streamed hits are the JAX streaming index's over the same memmap and
    weights (1e-3: one bf16 rounding of a query component may differ);
    ``serve`` answers /search likewise (for streaming the query command's
    rows up to ties: the server's batch encodes the queries in another
    padding, which may move an approximate index's candidate pool)."""
    root, _, exp, jenc = workdir
    idx = built_compressed[kind]
    with open(os.path.join(idx, "index_meta.json")) as f:
        meta = json.load(f)
    flags = ["--index_dir", idx, "--model_path", exp, "--index_dtype", kind]
    if command == "build":
        assert meta["n_docs"] == 400 and meta.get("dtype", "float32") == (
            "float32" if kind == "streaming" else kind)
        files = {"pq": ["pq_codes.npy", "pq_codebooks.npy", "pq_refine_rows.npy"],
                 "ivfpq": ["ivfpq_cell_codes.npy", "ivfpq_codebooks.npy",
                           "ivfpq_refine_rows.npy"],
                 "streaming": ["embeddings.npy", "docs.json"]}[kind]
        assert all(os.path.isfile(os.path.join(idx, f)) for f in files)
        if kind == "ivfpq":
            assert (meta["bits"], meta["n_probe"]) == (4, 8)
        if kind == "streaming":   # the memmap holds the embeddings, as the JAX encoder's
            np.testing.assert_allclose(np.load(os.path.join(idx, "embeddings.npy")),
                                       jenc.encode(DOCS), rtol=0, atol=1e-5)
        jidx, _ = jax_load_index(idx, dtype="streaming" if kind == "streaming" else None)
        assert jidx.n_docs == 400          # qst_tpu reloads the port's artifact
        return
    out = _run(["query", *flags, "--k", "4", "--queries", *QUERIES], capsys)
    emb = jenc.encode(DOCS)
    q = jenc.encode(QUERIES)
    cos = (q / np.linalg.norm(q, axis=1, keepdims=True)) @ (
        emb / np.linalg.norm(emb, axis=1, keepdims=True)).T
    got = (np.array([[h["score"] for h in o["hits"]] for o in out]),
           np.array([[h["id"] for h in o["hits"]] for o in out]))

    def check(s, i, texts):
        assert s.shape == (len(QUERIES), 4) and all(DOCS[d] == t for d, t in zip(
            i.ravel(), texts))
        np.testing.assert_allclose(s, np.take_along_axis(cos, i, 1), rtol=0, atol=1e-2)

    check(*got, [h["text"] for o in out for h in o["hits"]])
    if kind == "streaming":
        jidx, _ = jax_load_index(idx, dtype="streaming")
        assert_topk_equal_up_to_ties(*got, *jidx.search(q, k=4), rtol=0, atol=1e-3)
    if command == "serve":
        args = tmain.build_parser().parse_args(
            ["serve", *flags, "--port", "0", "--encoder_preset", "tiny", "--device", "cpu",
             "--max_wait_ms", "10"])
        server = tmain.serving_server(args, tmain.serving_retriever(args))
        port = server.start()
        try:
            rows = _request(port, "/search", {"queries": QUERIES, "k": 4,
                                              "return_texts": True})["results"]
        finally:
            server.stop()
        served = (np.array([[h[1] for h in row] for row in rows]),
                  np.array([[h[0] for h in row] for row in rows]))
        check(*served, [h[2] for row in rows for h in row])
        if kind == "streaming":
            assert_topk_equal_up_to_ties(*served, *got, rtol=0, atol=1e-3)


def _flags(parser):
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {cmd: {a.dest: (a.default, a.type, tuple(a.choices) if a.choices else None,
                           tuple(a.option_strings))
                  for a in p._actions if a.dest != "help"}
            for cmd, p in sub.choices.items()}


def test_parser_keeps_the_source_flags_and_defaults():
    """Every flag of qst_tpu's index_main, with its default, type and
    choices; the port adds --device alone."""
    want, got = _flags(jmain.build_parser()), _flags(tmain.build_parser())
    assert set(got) == set(want) == {"build", "serve", "query"}
    for cmd in want:
        assert got[cmd].pop("device") == (None, None, None, ("--device",))
        assert got[cmd] == want[cmd], cmd


def _request(port, path, obj, method="POST"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"}, method=method)
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("updatable", [False, True])
def test_serve_command_construction(workdir, built, updatable):
    """What ``serve`` builds before it blocks: the loaded retriever
    (converted with --updatable) behind a RetrievalServer."""
    _, _, exp, _ = workdir
    argv = ["serve", "--index_dir", built["ivf"], "--index_dtype", "ivf", "--port", "0",
            "--model_path", exp, "--encoder_preset", "tiny", "--device", "cpu",
            "--max_wait_ms", "10", "--capacity", "512"]
    args = tmain.build_parser().parse_args(argv + (["--updatable"] if updatable else []))
    retriever = tmain.serving_retriever(args)
    assert retriever._is_updatable() == updatable
    if updatable:
        assert retriever.index.capacity == 512
    server = tmain.serving_server(args, retriever)
    port = server.start()
    try:
        rows = _request(port, "/search", {"queries": QUERIES[:2], "k": 3,
                                          "return_texts": True})["results"]
        assert [len(r) for r in rows] == [3, 3]
        assert all(text == DOCS[doc_id] for row in rows for doc_id, _, text in row)
        if updatable:
            assert _request(port, "/docs", {"texts": ["a brand new zebra"],
                                            "ids": ["z"]}) == {"ids": ["z"]}
            hit = _request(port, "/search", {"queries": ["a brand new zebra"], "k": 1})
            assert hit["results"][0][0][0] == "z"
            assert _request(port, "/docs", {"ids": ["z"]}, method="DELETE") == {"removed": 1}
    finally:
        server.stop()


# ------------------------------------------------------------ cli/common.py
@pytest.mark.parametrize("preset", sorted(jcommon.ENCODER_PRESETS))
def test_encoder_from_args_matches_source(preset):
    kw = dict(max_seq_length=64, dtype="float32", use_fused_layer=True)
    for kwargs in ({}, kw):
        assert (dataclasses.asdict(tcommon.encoder_from_args(preset, **kwargs))
                == dataclasses.asdict(jcommon.encoder_from_args(preset, **kwargs)))
    assert sorted(tcommon.ENCODER_PRESETS) == sorted(jcommon.ENCODER_PRESETS)


def test_common_helpers(tmp_path, workdir):
    with pytest.raises(ValueError, match="unknown encoder preset"):
        tcommon.encoder_from_args("bert-huge")
    assert isinstance(tcommon.tokenizer_from_args(None, 512), HashTokenizer)
    p = argparse.ArgumentParser()
    tcommon.add_bool_flag(p, "fast", True, help="h")
    tcommon.add_device_flag(p)
    args = p.parse_args(["--no-fast", "--device", "cpu"])
    assert args.fast is False and args.device == "cpu" and p.parse_args([]).device is None
    path = tcommon.dump_args(args, str(tmp_path / "out"), manual_notes="n")
    with open(path) as f:
        assert json.load(f) == {"fast": False, "device": "cpu", "manual_notes": "n"}
    with pytest.raises(FileNotFoundError, match="no best checkpoint"):
        tcommon.load_best_params(str(tmp_path / "no_exp"))
    sd = tcommon.load_best_params(workdir[2])
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu" for v in sd.values())



# ------------------------------------------------ train_main and ir_eval_main


def _plain_flags(parser):
    return {a.dest: (a.default, a.type, tuple(a.choices) if a.choices else None,
                     tuple(a.option_strings))
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("jmod,tmod", [(jtrain_main, ttrain_main), (jir_main, tir_main)])
def test_train_and_ir_eval_parsers_keep_the_source_flags(jmod, tmod):
    want, got = _plain_flags(jmod.build_parser()), _plain_flags(tmod.build_parser())
    assert got.pop("device") == (None, None, None, ("--device",))
    assert got == want


@pytest.fixture(scope="module")
def quad_data(tmp_path_factory):
    """A chunked quadruplet dataset (48 instances) and an experiment dir
    holding qst_tpu's tiny-preset weights as the port's best checkpoint."""
    from helpers import write_synthetic_dataset

    root = tmp_path_factory.mktemp("quad")
    data = str(root / "data")
    write_synthetic_dataset(data, n_chunks=4, chunk_dim=12)
    jcfg = JaxConfig.tiny()
    params = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.key(7)))
    exp = str(root / "carried")
    _save(state_dict_from_flax_params(params, EncoderConfig(**dataclasses.asdict(jcfg))),
          os.path.join(exp, "checkpoints", "best", "params.pt"))
    return root, data, exp, JaxSentenceEncoder(jcfg, params, JaxHashTokenizer(jcfg.vocab_size))


@pytest.mark.parametrize("mode", ["1", "-1"])
def test_train_cli_mines_evaluates_and_checkpoints(quad_data, mode):
    """``train_main`` with the fused layer and loss, mining in mode 1 or −1
    and the IR evaluator: every evaluator scores epoch −1 and each
    evaluation step, the eval set is qst_tpu's, the best model is saved."""
    root, data, _, _ = quad_data
    exp = str(root / f"train{mode}")
    assert ttrain_main.main([
        "--dataset_root", data, "--experiment_dir", exp, "--encoder_preset", "tiny",
        "--device", "cpu", "--use_fused_layer", "--use_fused_loss_kernel",
        "--hard_contrastive_mode", mode, "--use_ir_evaluator", "--batch_size", "8",
        "--epochs", "1", "--evaluation_steps", "2", "--warmup_steps", "2",
        "--learning_rate", "1e-3"]) == 0
    steps = [(-1, -1), (0, 2), (0, 4), (0, 6), (0, 6)]       # 48 // 8 = 6 steps
    with open(os.path.join(exp, "quadruplet_results.csv")) as f:
        rows = list(csv.reader(f))[1:]
    assert [(int(r[0]), int(r[1])) for r in rows] == steps
    with open(os.path.join(exp, "ir_results.csv")) as f:
        ir_rows = list(csv.reader(f))[1:]
    assert sorted({(int(r[0]), int(r[1])) for r in ir_rows}) == sorted(set(steps))
    assert len(ir_rows) == len(steps) * 3 * 44
    with open(os.path.join(exp, "val_quadruplet_loss_eval.json")) as f:
        log = json.load(f)
    assert [(e["epoch"], e["steps"]) for e in log] == steps
    assert all(np.isfinite(e["average_loss"]) for e in log)
    with open(os.path.join(exp, "ir_eval_set.json")) as f:
        written = json.load(f)
    want = jax_create_ir_evaluation_set(list(JaxChunkStore(data).iter_instances()), seed=14)
    assert written == want.to_json()
    with open(os.path.join(exp, "command_line_args.json")) as f:
        assert json.load(f)["hard_contrastive_mode"] == int(mode)
    assert tcommon.load_best_params(exp).keys() == state_dict_from_flax_params(
        jax.tree.map(np.asarray, jax_init_params(JaxConfig.tiny(), jax.random.key(0))),
        EncoderConfig.tiny()).keys()


def _carried_to_jax(index):
    """The JAX package's counterpart of a port-built PQ / IVF-PQ index over
    the same codes, codebooks and refine rows."""
    host = lambda t: t.cpu().numpy()  # noqa: E731
    if index.__class__.__name__ == "PQIndex":
        return lambda emb, ids, m: JaxPQIndex.from_codes(
            host(index.codes)[: index.n_docs], host(index.codebooks), ids=ids,
            refine_rows=index.refine_rows_f32())
    return lambda emb, ids, m: JaxIVFPQIndex.from_arrays(
        host(index.centroids), host(index.cell_codes), host(index.cell_ids),
        host(index.codebooks), host(index.fill), ids=ids,
        default_n_probe=index.default_n_probe, residual=index.residual,
        refine_rows=index.refine_rows_f32(), bits=index.bits)


@pytest.mark.parametrize("index", ["exact", "ivf", "pq", "ivfpq"])
def test_ir_eval_cli_matches_the_jax_evaluator(quad_data, index, monkeypatch):
    """``ir_eval_main`` over the exact, IVF, PQ and IVF-PQ indexes: the
    baseline and the trained model (qst_tpu's weights carried into the
    port's checkpoint), the trained metrics held to qst_tpu's evaluator over
    the same weights within 1e-6 (exact; IVF at full probe: the exact
    search's metrics), euclid dropped for the approximate indexes as in the
    source. PQ and IVF-PQ: the metrics at k ≤ 5, so the refine ×8 re-ranks
    40 of the 268 documents that the codes select; qst_tpu's evaluator
    searches the port-built index's codes, codebooks and refine rows carried
    into its own PQ / IVF-PQ index (the two packages draw their training
    differently)."""
    from qst_tpu_torch import retrieval as tretrieval

    root, data, exp, jenc = quad_data
    out = str(root / f"ir_{index}")
    ks = {}
    built = []
    if index in ("pq", "ivfpq"):
        ks = dict(accuracy_at_k=(1, 3, 5), precision_recall_at_k=(1, 3, 5), mrr_at_k=(5,),
                  ndcg_at_k=(5,), map_at_k=(5,))
        cls = getattr(tretrieval, {"pq": "PQIndex", "ivfpq": "IVFPQIndex"}[index])

        def recording(*args, **kw):
            built.append(cls(*args, **kw))
            return built[-1]

        monkeypatch.setattr(tretrieval, cls.__name__, recording)
    argv = ["--dataset_root", data, "--model_path", exp, "--encoder_preset", "tiny",
            "--device", "cpu", "--output_root", out, "--eval_index", index,
            "--eval_ivf_clusters", "4", "--eval_ivf_probe", "4", "--eval_pq_m", "8",
            "--n_queries", "20"]
    for name, values in ks.items():
        argv += [f"--{name}", *map(str, values)]
    assert tir_main.main(argv) == 0
    [hashed] = os.listdir(out)
    with open(os.path.join(out, hashed, "results.json")) as f:
        results = json.load(f)
    assert set(results) == {"baseline", "trained"}
    fns = ["cos_sim", "dot_score"] + (["euclid_score"] if index == "exact" else [])
    with open(os.path.join(out, hashed, "ir_eval_set.json")) as f:
        eval_set = json.load(f)
    jset = jax_create_ir_evaluation_set(list(JaxChunkStore(data).iter_instances()),
                                        n_queries=20, seed=14)
    assert eval_set == jset.to_json()
    if built:   # baseline then trained; the candidate pool is smaller than the corpus
        assert len(built) == 2 and 5 * 8 < built[-1].n_docs == len(jset.corpus)
        # and the pools themselves (the codes' ranking, no refine) are qst_tpu's
        q = jenc.encode(list(jset.queries.values()))
        jidx = _carried_to_jax(built[-1])(None, built[-1].ids, None)
        pos = {d: i for i, d in enumerate(built[-1].ids)}
        pools = [(np.asarray(s), np.array([[pos[d] for d in row] for row in ids]))
                 for s, ids in (idx.search_ids(q, k=40, refine_factor=0)
                                for idx in (built[-1], jidx))]
        assert_topk_equal_up_to_ties(*pools[0], *pools[1], rtol=1e-6, atol=1e-5)
    ev = JaxIREvaluator(jset.queries, jset.corpus, jset.relevant,
                        cfg=JaxIREvalConfig(n_queries=20, score_functions=tuple(fns), **ks),
                        index_factory=_carried_to_jax(built[-1]) if built else None)
    ev(lambda texts: jenc.encode(list(texts)))
    assert list(results["trained"]["metrics"]) == fns
    for fn in fns:
        for name, value in ev.last_results[fn].items():
            assert results["trained"]["metrics"][fn][name] == pytest.approx(value, abs=1e-6), (
                fn, name)
    assert results["baseline"]["metrics"] != results["trained"]["metrics"]


@pytest.mark.parametrize("argv", [
    ["--mesh_data", "2"], ["--mesh_model", "2"], ["--pp_stages", "2", "--mesh_model", "2"],
    ["--pp_stages", "2", "--use_fused_layer"],
], ids=["mesh_data", "mesh_model", "pp_and_model", "pp_and_fused"])
def test_train_cli_refuses_unported_flags(quad_data, argv, monkeypatch):
    """The mesh flags train as qst_tpu's CLI does on its 8 devices (the
    port's 8 positions of the host: ``$QST_TORCH_VIRTUAL_DEVICES``), from
    the same weights file and data: the same evaluation steps, the same
    scores before the first step, and a flat best artifact; the pipeline's
    two exclusions exit as qst_tpu's do."""
    root, data, exp_carried, _ = quad_data
    monkeypatch.setenv("QST_TORCH_VIRTUAL_DEVICES", "8")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)          # eight shards of tiny ops: a thread pool only slows them
    try:
        _mesh_flags_against_jax(root, data, exp_carried, argv)
    finally:
        torch.set_num_threads(threads)


def _mesh_flags_against_jax(root, data, exp_carried, argv):
    w = str(root / "mesh_weights.bin")
    torch.save({f"bert.{k}": v for k, v in tcommon.load_best_params(exp_carried).items()}, w)
    name = "_".join(a.strip("-") for a in argv)
    flags = ["--dataset_root", data, "--encoder_preset", "tiny", "--batch_size", "8",
             "--epochs", "1", "--evaluation_steps", "3", "--hf_checkpoint", w, *argv]
    if "--pp_stages" in argv:
        with pytest.raises(SystemExit, match="exclusive") as port:
            ttrain_main.main([*flags, "--experiment_dir", str(root / f"t_{name}"),
                              "--device", "cpu"])
        with pytest.raises(SystemExit, match="exclusive") as jax_exit:
            jtrain_main.main([*flags, "--experiment_dir", str(root / f"j_{name}")])
        if "--mesh_model" in argv:
            assert str(port.value) == str(jax_exit.value)
        return
    runs = {}
    for who, fn, extra in (("port", ttrain_main.main, ["--device", "cpu"]),
                           ("jax", jtrain_main.main, [])):
        exp = str(root / f"{who}_{name}")
        assert fn([*flags, "--experiment_dir", exp, *extra]) == 0
        with open(os.path.join(exp, "quadruplet_results.csv")) as f:
            runs[who] = list(csv.reader(f))[1:]
    assert [r[:2] for r in runs["port"]] == [r[:2] for r in runs["jax"]] == [
        ["-1", "-1"], ["0", "3"], ["0", "6"], ["0", "6"]]
    np.testing.assert_allclose([float(v) for v in runs["port"][0][2:]],
                               [float(v) for v in runs["jax"][0][2:]], atol=1e-6)
    best = tcommon.load_best_params(str(root / f"port_{name}"))
    assert best.keys() == tcommon.load_best_params(exp_carried).keys()


@pytest.mark.parametrize("fused", [False, True], ids=["module", "fused"])
def test_train_cli_steps_per_call_gives_the_single_step_run(quad_data, fused):
    """``--steps_per_call 2`` (6 steps an epoch: three calls of two) gives
    the ``--steps_per_call 1`` run: the same logged losses and the same best
    and final weights, dropout 0.1 included — each step's draws follow from
    (seed, step) whichever way it runs."""
    root, data, _, _ = quad_data
    runs = {}
    for k in ("1", "2"):
        exp = str(root / f"spc{k}_{fused}")
        assert ttrain_main.main([
            "--dataset_root", data, "--experiment_dir", exp, "--encoder_preset", "tiny",
            "--device", "cpu", "--batch_size", "8", "--epochs", "1", "--evaluation_steps", "2",
            "--warmup_steps", "2", "--learning_rate", "1e-3", "--steps_per_call", k,
            *(["--use_fused_layer", "--use_fused_loss_kernel"] if fused else [])]) == 0
        with open(os.path.join(exp, "train_loss.json")) as f:
            losses = json.load(f)
        runs[k] = (losses, tcommon.load_best_params(exp),
                   torch.load(os.path.join(exp, "checkpoints", "periodic", "6", "state.pt"),
                              weights_only=False)["model"])
    assert [e["steps"] for e in runs["2"][0]] == [e["steps"] for e in runs["1"][0]] == [2, 4, 6]
    assert runs["2"][0] == runs["1"][0]
    for a, b in zip(runs["2"][1:], runs["1"][1:]):
        assert a.keys() == b.keys() and all(torch.equal(a[n], b[n]) for n in a)


@pytest.mark.parametrize("module", ["dataset_main", "train_main"])
def test_entry_points_run_on_the_card_unless_told(quad_data, tmp_path, module):
    """Without ``--device`` the CLIs ask for the GPU and fail without one."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    from qst_tpu_torch.cli import dataset_main as tdm

    root, data, _, _ = quad_data
    argv = {"dataset_main": (tdm, ["--ann_file", "x.json", "--output_root", str(tmp_path)]),
            "train_main": (ttrain_main, ["--dataset_root", data, "--experiment_dir",
                                         str(tmp_path / "e"), "--steps_per_call", "4"])}
    cli, flags = argv[module]
    with pytest.raises(RuntimeError, match="no CUDA device.*device='cpu'"):
        cli.main(flags)


def test_dataset_parser_keeps_the_source_flags():
    from qst_tpu.cli import dataset_main as jdm
    from qst_tpu_torch.cli import dataset_main as tdm

    want, got = _plain_flags(jdm.build_parser()), _plain_flags(tdm.build_parser())
    assert got.pop("device") == (None, None, None, ("--device",))
    assert got == want


# the IR grid of tests/test_cli.py:167: a sharded JAX search takes k <= a shard's rows
SMALL_IR_GRID = ["--accuracy_at_k", "1", "--precision_recall_at_k", "1", "--mrr_at_k", "3",
                 "--ndcg_at_k", "3", "--map_at_k", "3", "--score_functions", "cos_sim",
                 "dot_score"]


def _ir_results(main, out: str, argv) -> dict:
    assert main(["--output_root", out, "--n_queries", "12", *SMALL_IR_GRID, *argv]) == 0
    [hashed] = [d for d in os.listdir(out) if os.path.isfile(os.path.join(out, d, "results.json"))]
    with open(os.path.join(out, hashed, "results.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("argv", [["--mesh_data", "2"], ["--mesh_model", "2"]])
def test_ir_eval_cli_refuses_unported_flags(quad_data, argv, monkeypatch):
    """``--mesh_data`` / ``--mesh_model`` (refused before they were
    ported): over two positions of ``$QST_TORCH_VIRTUAL_DEVICES`` the
    baseline's and the trained model's metrics are the run's without a
    mesh; with one visible device a 2-position mesh is refused."""
    root, data, exp, _ = quad_data
    common = ["--dataset_root", data, "--model_path", exp, "--encoder_preset", "tiny",
              "--device", "cpu"]
    with pytest.raises(ValueError, match="more than 1 devices|1 devices not divisible"):
        tir_main.main([*common, "--output_root", str(root / "refused_ir"), *argv])
    plain = _ir_results(tir_main.main, str(root / f"ir_plain_{argv[0]}"), common)
    monkeypatch.setenv("QST_TORCH_VIRTUAL_DEVICES", "2")
    meshed = _ir_results(tir_main.main, str(root / f"ir_mesh_{argv[0]}"), common + argv)
    for run in ("baseline", "trained"):
        for fn, metrics in plain[run]["metrics"].items():
            for name, value in metrics.items():
                assert meshed[run]["metrics"][fn][name] == pytest.approx(value, abs=1e-6)


def test_ir_eval_cli_refuses_a_group_of_processes(quad_data, monkeypatch):
    """A process group of more than one process (``$QST_COORDINATOR_ADDRESS``)
    is refused before any work, and the group is taken down: the mesh spans
    one process's devices, so each process would run the whole evaluation
    into the same output root."""
    import torch.distributed as dist

    from qst_tpu_torch.core import meshes

    root, data, exp, _ = quad_data
    calls = []
    monkeypatch.setattr(meshes, "initialize_distributed",
                        lambda device=None: calls.append(("init", device)) or True)
    monkeypatch.setattr(dist, "get_rank", lambda: 0)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(dist, "destroy_process_group", lambda: calls.append("destroy"))
    out = root / "ir_two_processes"
    with pytest.raises(SystemExit, match="QST_COORDINATOR_ADDRESS with more than one process"):
        tir_main.main(["--dataset_root", data, "--model_path", exp, "--encoder_preset", "tiny",
                       "--device", "cpu", "--output_root", str(out)])
    assert calls == [("init", "cpu"), "destroy"] and not out.exists()


def test_ir_eval_cli_mesh_matches_the_jax_cli(quad_data, monkeypatch):
    """``ir_eval_main --mesh_data 8 --device cpu`` (eight positions of
    ``$QST_TORCH_VIRTUAL_DEVICES``) against qst_tpu's CLI with
    ``--mesh_data 8`` on its eight virtual devices (after
    tests/test_cli.py:167), both over the same weights (the trained model:
    qst_tpu's orbax checkpoint and the port's copy of it): the eval set and
    the trained metrics within 1e-6 (the baselines are each package's own
    random init)."""
    import orbax.checkpoint as ocp

    root, data, exp, jenc = quad_data
    jexp = str(root / "jax_exp")
    ckpt = ocp.StandardCheckpointer()
    ckpt.save(os.path.join(jexp, "checkpoints", "best", "params"), jenc.params, force=True)
    ckpt.wait_until_finished()
    common = ["--dataset_root", data, "--encoder_preset", "tiny", "--mesh_data", "8"]
    want = _ir_results(jir_main.main, str(root / "ir_jax_mesh"), common + ["--model_path", jexp])
    monkeypatch.setenv("QST_TORCH_VIRTUAL_DEVICES", "8")
    got = _ir_results(tir_main.main, str(root / "ir_port_mesh"),
                      common + ["--model_path", exp, "--device", "cpu"])
    assert set(got["trained"]["metrics"]) == {"cos_sim", "dot_score"}
    for fn, metrics in want["trained"]["metrics"].items():
        for name, value in metrics.items():
            assert got["trained"]["metrics"][fn][name] == pytest.approx(value, abs=1e-6), (
                fn, name)
    with open(os.path.join(root / "ir_jax_mesh", os.listdir(root / "ir_jax_mesh")[0],
                           "ir_eval_set.json")) as f:
        jset = json.load(f)
    [port_dir] = os.listdir(root / "ir_port_mesh")
    with open(os.path.join(root / "ir_port_mesh", port_dir, "ir_eval_set.json")) as f:
        assert json.load(f) == jset


def test_ir_eval_cli_generates_query_variations_as_the_jax_cli(quad_data):
    """``--generate_query_variations`` (refused before it was ported): the
    eval set is qst_tpu's with its variations (the JAX CLI's
    ``generate_variations(text, n=1, seed)``), and the trained metrics are
    qst_tpu's evaluator's over the same weights within 1e-6."""
    from qst_tpu.data.sentence_compression import generate_variations as jgen

    root, data, exp, jenc = quad_data
    out = str(root / "ir_variations")
    assert tir_main.main(["--dataset_root", data, "--model_path", exp, "--encoder_preset",
                          "tiny", "--device", "cpu", "--output_root", out, "--n_queries", "20",
                          "--generate_query_variations"]) == 0
    [hashed] = os.listdir(out)
    with open(os.path.join(out, hashed, "ir_eval_set.json")) as f:
        eval_set = json.load(f)
    jset = jax_create_ir_evaluation_set(
        list(JaxChunkStore(data).iter_instances()), n_queries=20, seed=14,
        query_variation_fn=lambda text: jgen(text, n=1, seed=14)[0])
    assert eval_set == jset.to_json()
    plain = jax_create_ir_evaluation_set(list(JaxChunkStore(data).iter_instances()),
                                         n_queries=20, seed=14)
    assert jset.queries != plain.queries
    with open(os.path.join(out, hashed, "results.json")) as f:
        results = json.load(f)
    fns = ("cos_sim", "dot_score", "euclid_score")
    ev = JaxIREvaluator(jset.queries, jset.corpus, jset.relevant,
                        cfg=JaxIREvalConfig(n_queries=20, score_functions=fns))
    ev(lambda texts: jenc.encode(list(texts)))
    for fn in fns:
        for name, value in ev.last_results[fn].items():
            assert results["trained"]["metrics"][fn][name] == pytest.approx(value, abs=1e-6)


def _tiny_dir(root, arch: str, weights: str = "model.safetensors"):
    """A random-init sentence-transformers directory of the port's exporter:
    2 layers, H 32, max_seq_length 20, a small WordPiece vocab."""
    from qst_tpu_torch.models.hf_export import save_checkpoint_dir
    from qst_tpu_torch.models.sentence_encoder import init_params

    cfg = EncoderConfig(name=f"dir-{arch}", arch=arch, vocab_size=40, hidden_size=32,
                        num_layers=2, num_heads=2, intermediate_size=64,
                        max_position_embeddings=40, max_seq_length=20,
                        pad_token_id=1 if arch == "mpnet" else 0)
    vocab = ["[PAD]", "<s>", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [
        w for w in "a the cat dog car red on in mat park road of pasta beach plane sky people "
        "sand young small with sauce runs sits variant scene image photo of".split()][:34]
    sd = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    return cfg, sd, save_checkpoint_dir(sd, cfg, str(root / f"dir_{arch}_{weights}"),
                                        vocab=vocab, weights=weights)


@pytest.mark.parametrize("arch", ["bert", "mpnet"])
def test_train_cli_takes_a_checkpoint_dir(quad_data, arch):
    """``--hf_checkpoint_dir``: the directory's architecture, widths and
    weights are what trains (the best checkpoint holds its names and its
    shapes, and the evaluation before the first step scores its weights
    as the same run from those weights as a file does)."""
    root, data, _, _ = quad_data
    cfg, sd, d = _tiny_dir(root, arch)
    flags = ["--dataset_root", data, "--device", "cpu", "--use_fused_layer",
             "--use_fused_loss_kernel", "--batch_size", "8", "--epochs", "1",
             "--evaluation_steps", "3", "--warmup_steps", "2", "--learning_rate", "1e-3"]
    exp = str(root / f"hfdir_{arch}")
    assert ttrain_main.main([*flags, "--experiment_dir", exp, "--hf_checkpoint_dir", d]) == 0
    best = tcommon.load_best_params(exp)
    assert best.keys() == sd.keys()
    assert all(best[k].shape == sd[k].shape for k in sd)
    with open(os.path.join(exp, "quadruplet_results.csv")) as f:
        first = list(csv.reader(f))[1]
    assert (int(first[0]), int(first[1])) == (-1, -1)


def test_train_cli_takes_a_weights_file(quad_data):
    """``--hf_checkpoint``: a weights file at the preset's widths."""
    root, data, exp_carried, _ = quad_data
    w = str(root / "tiny_weights.bin")
    torch.save({f"bert.{k}": v for k, v in tcommon.load_best_params(exp_carried).items()}, w)
    exp = str(root / "hffile")
    assert ttrain_main.main([
        "--dataset_root", data, "--experiment_dir", exp, "--encoder_preset", "tiny",
        "--device", "cpu", "--batch_size", "8", "--epochs", "1", "--evaluation_steps", "3",
        "--hf_checkpoint", w]) == 0
    assert tcommon.load_best_params(exp).keys() == tcommon.load_best_params(exp_carried).keys()


@pytest.mark.parametrize("arch", ["bert", "mpnet"])
def test_ir_eval_cli_takes_a_checkpoint_dir(quad_data, arch):
    """``ir_eval_main --hf_checkpoint_dir``: the baseline is the directory's
    encoder, in its own compute dtype (bf16): its metrics are those of the
    port's evaluator over ``load_hf_checkpoint_dir``'s encoder (the two
    packages' encoders agree at f32 in tests/test_torch_hf.py; in bf16 the
    near-ties of a random model's rankings fall apart)."""
    from qst_tpu_torch.core.config import IREvalConfig
    from qst_tpu_torch.evals.eval_set import create_ir_evaluation_set
    from qst_tpu_torch.evals.ir_evaluator import InformationRetrievalEvaluator
    from qst_tpu_torch.models.hf_import import load_hf_checkpoint_dir
    from qst_tpu_torch.models.sentence_encoder import SentenceEncoder
    from qst_tpu_torch.models.tokenizer import load_tokenizer

    root, data, _, _ = quad_data
    _, _, d = _tiny_dir(root, arch, weights="pytorch_model.bin")
    out = str(root / f"ir_hfdir_{arch}")
    assert tir_main.main(["--dataset_root", data, "--hf_checkpoint_dir", d, "--device", "cpu",
                          "--output_root", out, "--n_queries", "20"]) == 0
    [hashed] = os.listdir(out)
    with open(os.path.join(out, hashed, "results.json")) as f:
        results = json.load(f)
    assert set(results) == {"baseline"}
    cfg, sd, vocab = load_hf_checkpoint_dir(d)
    assert cfg.arch == arch and cfg.dtype == "bfloat16"
    enc = SentenceEncoder(cfg, sd, load_tokenizer(vocab, vocab_size=cfg.vocab_size),
                          device="cpu")
    es = create_ir_evaluation_set(list(JaxChunkStore(data).iter_instances()), n_queries=20,
                                  seed=14)
    fns = ("cos_sim", "dot_score", "euclid_score")
    ev = InformationRetrievalEvaluator(es.queries, es.corpus, es.relevant,
                                       cfg=IREvalConfig(n_queries=20,
                                                      score_functions=fns))
    ev(enc.encode)
    assert results["baseline"]["metrics"] == ev.last_results
