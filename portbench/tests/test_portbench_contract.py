"""The result line, the registry's files, the counts and the no-JAX rule."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from portbench_rehearsal import CELLS, ROOT, rehearse


@pytest.mark.parametrize("cell", CELLS)
def test_last_line_matches_the_contract(cell):
    line = rehearse(cell)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    assert "setup_s" in line["metrics"]
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_traced_line_carries_per_layer_metrics():
    line = rehearse("mpnet_base.encode_long", trace=1)
    assert "real_token_pct.encode" in line["metrics"]
    assert "encode_docs_per_s" not in line["metrics"]
    assert 0 < line["metrics"]["real_token_pct.encode"]["value"] <= 100


def test_benchmark_names_files_that_exist():
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in bench["workloads"]:
        spec = json.load(open(os.path.join(ROOT, "portbench", "workloads", w["name"] + ".json")))
        assert (spec["config"], spec["traffic"]) == (w["config"], w["traffic"])
        assert os.path.isfile(os.path.join(ROOT, "portbench", "traffic", w["traffic"] + ".json"))
    for m in bench["per_layer"]:
        assert os.path.isfile(os.path.join(ROOT, "portbench", "metrics", m["name"] + ".py"))


def test_a_cell_config_traffic_and_metric_added_as_files_alone(tmp_path):
    """A new configuration, traffic mix, cell and per-layer metric, each a new
    file, run without an edit to any file the benchmark has."""
    here = os.path.join(ROOT, "portbench")
    made = []

    def add(kind, name, body):
        path = os.path.join(here, kind, name)
        assert not os.path.exists(path)
        with open(path, "w") as f:
            f.write(body)
        made.append(path)

    cfg = json.load(open(os.path.join(here, "configs", "mpnet_base.json")))
    cfg.update(name="zz_added", num_hidden_layers=1, hidden_size=32, num_attention_heads=2,
               intermediate_size=64, vocab_size=700, max_seq_length=32)
    traffic = json.load(open(os.path.join(here, "traffic", "long_docs.json")))
    traffic.update(pool=40, texts_per_call=20, batch_size=8, warm_calls=1,
                   lengths={"unit": "tokens", "kind": "lognormal", "median": 12, "sigma": 0.5,
                            "min": 4, "max": 40})
    cell = {"config": "zz_added", "traffic": "zz_added", "chips": 1, "main_kernels": ["K1"],
            "limits": {"embedding_gap": 1.0},
            "check": {"every": 2, "sample": 8, "min_compared": 4}}
    try:
        add("configs", "zz_added.json", json.dumps(cfg))
        add("traffic", "zz_added.json", json.dumps(traffic))
        add("workloads", "zz_added.cell.json", json.dumps(cell))
        add("metrics", "zz_added.tokens.py",
            "def read(observed):\n    return float(sum(observed['lengths']))\n")
        bench = {"end_to_end": [{"name": "encode_docs_per_s", "unit": "docs/s"},
                                {"name": "setup_s", "unit": "s"}],
                 "per_layer": [{"name": "zz_added.tokens", "unit": "tokens",
                                "moves": "encode_docs_per_s", "workloads": ["zz_added.cell"]}]}
        (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
        plain = rehearse("zz_added.cell", root=str(tmp_path))
        traced = rehearse("zz_added.cell", trace=1, root=str(tmp_path))
    finally:
        for path in made:
            os.remove(path)
    assert plain["correct"] and "encode_docs_per_s" in plain["metrics"]
    assert traced["metrics"]["zz_added.tokens"]["value"] > 0


def test_operations_and_bytes_against_hand_counts():
    from portbench import work

    cfg = {"hidden_size": 4, "intermediate_size": 8, "num_hidden_layers": 2}
    # a layer on lengths 3 and 5: 2·(4·16 + 2·4·8) = 256 a token, 4·L²·4 attention
    assert work.layer_flops(cfg, [3, 5]) == 256 * 8 + 16 * (9 + 25)
    assert work.encoder_flops(cfg, [3, 5]) == 2 * (256 * 8 + 16 * 34)
    assert work.train_flops(cfg, [3]) == 3 * 2 * (256 * 3 + 16 * 9)
    # weights 2·(64 + 64) bytes a launch, input and output 2·2·8·4
    assert work.layer_bytes(cfg, [3, 5], launches=3) == 3 * 256 + 128
    pct = work.roofline_pct(989e12, 0.0, 2.0, "NVIDIA H100 80GB HBM3")
    assert pct == pytest.approx(50.0)
    assert work.roofline_pct(1.0, 1.0, 1.0, "some other card") is None


def test_real_tokens_against_hand_counts():
    from portbench import registry

    reader = registry.metric("real_token_pct.encode")
    assert reader.read({"lengths": np.array([3, 5, 8]), "slots": 2 * 16}) == pytest.approx(50.0)
    train = registry.metric("real_token_pct.train")
    assert train.read({"lengths": np.array([1] * 8), "slots": 32}) == pytest.approx(25.0)
    assert reader.read({"lengths": None, "slots": 0}) is None


def test_kernel_labels_split_k1_and_k2_by_the_step_and_the_launcher():
    from portbench import kernels

    names = ["void qst::gemm_bf16_kernel<0>(...)", "void qst::attention_mma_kernel<32>(...)",
             "void qst::quadruplet_fwd_kernel(...)", "void qst::quadruplet_bwd_kernel(...)",
             "void qst::layernorm_bwd_kernel<...>(...)", "void qst::gemm_bf16_kernel<5>(...)",
             "void at::native::multi_tensor_apply_kernel<...>(...)",
             "void qst::gemm_bf16_kernel<0>(...)", "Memcpy HtoD (Pinned -> Device)",
             "void qst::bucket_max_wgmma_kernel(...)", "void qst::rescore_mma_kernel(...)"]
    assert kernels.label_kernels(names) == ["K1", "K1", "K3", "K3", "K2", "K2", "optimizer",
                                            "K1", "memcpy", "K4", "K5"]
    # the same with the step's records from a graph replay and a miner's
    # forward (not from the graph) inside the step's backward
    graph = [True] * 5 + [False] + [True] * 5
    assert kernels.label_kernels(names, graph) == ["K1", "K1", "K3", "K3", "K2", "K1",
                                                   "optimizer", "K1", "memcpy", "K4", "K5"]
    assert kernels.base_name("void qst::attention_bwd_mma_kernel<32>(x)") == \
        "attention_bwd_mma_kernel"


def test_banned_modules_compare_whole_top_level_names():
    from portbench.run import banned_modules

    assert banned_modules(["qst_tpu_torch", "qst_tpu_torch.ops", "jaxtyping", "torch"]) == []
    assert banned_modules(["qst_tpu.models", "jax.numpy", "flax"]) == ["flax", "jax", "qst_tpu"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_dry_run_loads_no_jax(cell):
    """Each cell's rehearsal in a fresh process, which exits 3 if it loaded
    JAX or the JAX package; its modules are listed and checked here too."""
    code = ("import sys, runpy\n"
            "sys.argv = ['portbench.run', '--workload', %r, '--seed', '5', '--seconds', '0.5',"
            " '--dry-run']\n"
            "try:\n    runpy.run_module('portbench.run', run_name='__main__')\n"
            "except SystemExit as e:\n    rc = e.code\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
            "sys.exit(rc)\n" % cell)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = ast.literal_eval(out.stdout.strip().splitlines()[-1])
    assert not {"jax", "jaxlib", "flax", "optax", "qst_tpu"} & set(loaded)
    assert "qst_tpu_torch" in loaded


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(ROOT, "portbench", "reference")
    for name in os.listdir(ref):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(ref, name)).read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for m in mods:
                assert m.split(".")[0] not in {"qst_tpu_torch", "qst_tpu", "jax", "flax",
                                               "optax", "jaxlib"}, (name, m)
                assert not m.startswith("portbench") or m.startswith("portbench.reference"), \
                    (name, m)
    code = ("import sys, portbench.reference.encoder, portbench.reference.train, "
            "portbench.reference.wordpiece\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    loaded = ast.literal_eval(out.stdout.strip().splitlines()[-1])
    assert not {"qst_tpu_torch", "qst_tpu", "jax", "flax"} & set(loaded)
