"""The ablation's γ × margin-set sweep (``qst_tpu_torch/experiments/ablation.py
--gammas``) against the JAX script's (``benchmarks/ablation_quadruplet_vs_triplet.py
:113-122,303-337``): its flags, help and defaults, the JSON line's keys, the
cells' labels and the table's columns, read from the script's source; and, at
the ``tiny`` preset on the CPU through the fused path's plain versions two
steps a call, the cell γ = 0.6 / 1.0:0.5:0.5 trained to the bits of the
default mode's quadruplet arm and the sweep's triplet arm to the default
mode's — every arm starts from the same init on the same stream, and no
state leaks from one arm into the next."""

import ast
import copy
import json
import os
import re
import tempfile

import pytest
import torch

from qst_tpu_torch.experiments import ablation as abl

JAX_SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "benchmarks", "ablation_quadruplet_vs_triplet.py")
SMALL = ["--device", "cpu", "--preset", "tiny", "--steps", "8", "--n_images", "160",
         "--n_eval", "40", "--use_fused_layer", "--wordpiece", "--steps_per_call", "2"]
CELL = "gamma=0.6 margins=1.0/0.5/0.5"


def jax_source() -> str:
    with open(JAX_SCRIPT) as f:
        return f.read()


def jax_flag(flag: str) -> dict:
    """The JAX script's ``add_argument(flag, ...)`` keywords, as constants."""
    for node in ast.walk(ast.parse(jax_source())):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument"
                and node.args and ast.literal_eval(node.args[0]) == flag):
            kw = {k.arg: k.value for k in node.keywords}
            return {"default": ast.literal_eval(kw["default"]), "type": kw["type"].id,
                    "help": ast.literal_eval(kw["help"])}
    raise AssertionError(f"{flag} not in the JAX script")


@pytest.fixture(scope="module")
def runs():
    """The sweep at γ = 0.6 / 1.0:0.5:0.5 and the default mode, at the same
    arguments, one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        for mode, extra in (("sweep", ["--gammas", "0.6", "--margin_sets", "1.0:0.5:0.5"]),
                            ("default", [])):
            with tempfile.TemporaryDirectory(prefix="sweep_") as work:
                out[mode] = abl.run(abl.build_parser().parse_args(SMALL + extra), work)
    finally:
        torch.set_num_threads(n)
    return out


@pytest.mark.parametrize("flag", ["--gammas", "--margin_sets"])
def test_sweep_flags_are_the_jax_scripts(flag):
    """The flag's default, type and help text are the JAX script's."""
    want = jax_flag(flag)
    action = next(a for a in abl.build_parser()._actions if flag in a.option_strings)
    assert (action.default, action.type.__name__, action.help) == (
        want["default"], want["type"], want["help"])


def test_sweep_json_labels_and_columns_are_the_jax_scripts(runs, monkeypatch, capsys):
    """``main --gammas`` prints the JAX script's JSON line (its keys and
    metric name) and its table (its header); the cells are labelled with
    its format string, in its order (baseline, triplet, the cells)."""
    src = jax_source()
    header = re.search(r'rows = \["(\| cell[^"]*)"\s*"([^"]*)"', src)
    assert header and abl.sweep_table(runs["sweep"]["results"]).splitlines()[0] == \
        header.group(1) + header.group(2)
    assert 'label = f"gamma={g} margins={m_pn}/{m_pp}/{m_pn2}"' in src
    assert list(runs["sweep"]["results"]) == ["baseline", "triplet", CELL]
    keys = re.search(r'"metric": "ablation_gamma_margin_sweep",\s*"steps_per_arm": '
                     r'triplet_steps,\s*"results": results,', src)
    assert keys
    monkeypatch.setattr(abl, "run", lambda args, work: copy.deepcopy(runs["sweep"]))
    assert abl.main(SMALL + ["--gammas", "0.6"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    line = json.loads(lines[0])
    assert list(line) == ["metric", "steps_per_arm", "results"]
    assert line["metric"] == "ablation_gamma_margin_sweep"
    assert line["steps_per_arm"] == runs["sweep"]["steps_per_arm"]
    assert "\n".join(lines[1:]) == abl.sweep_table(runs["sweep"]["results"])
    assert len(lines) == 1 + 2 + 3          # the JSON line, the header, a row a model


@pytest.mark.parametrize("sweep_arm,default_arm", [(CELL, "quadruplet"),
                                                   ("triplet", "triplet")])
def test_sweep_arm_is_the_default_modes(runs, sweep_arm, default_arm):
    """The sweep's cell γ = 0.6 / 1.0:0.5:0.5 is the default mode's γ arm,
    and its triplet arm the default mode's triplet arm, bit for bit —
    weights and metrics."""
    got, want = runs["sweep"]["arms"][sweep_arm], runs["default"]["arms"][default_arm]
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert runs["sweep"]["results"][sweep_arm] == runs["default"]["results"][default_arm]
