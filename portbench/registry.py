"""Find a cell's pieces by name, each a file of its own:

- ``workloads/<cell>.json``: the cell's configuration and traffic names,
  the kernels its main layer must launch, the limits of its correctness
  numbers and the size of its check;
- ``configs/<config>.json``: a model's published sizes, what was cut and
  assumed, its precision;
- ``traffic/<traffic>.json``: the traffic driver that plays the mix and the mix's
  parameters (lengths, batches, pools);
- ``drivers/<driver>.py``: a ``run(run: Run) → Outcome``;
- ``metrics/<metric>.py``: a per-layer metric's ``read(observed)``.

A cell, a configuration, a traffic mix or a metric is added by adding its
file and naming it in ``BENCHMARK.json``; nothing here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass
from types import ModuleType
from typing import Any, Dict, Optional

HERE = os.path.dirname(os.path.abspath(__file__))


def _json(kind: str, name: str) -> Dict[str, Any]:
    path = os.path.join(HERE, kind, f"{name}.json")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1] if kind.endswith('s') else kind} named "
                                f"{name!r} ({path})")
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    spec: Dict[str, Any]       # workloads/<name>.json
    config: Dict[str, Any]     # configs/<config>.json
    traffic: Dict[str, Any]    # traffic/<traffic>.json

    @property
    def driver(self) -> str:
        return self.traffic["driver"]


def cell(name: str, dry_run: bool = False) -> Cell:
    spec = _json("workloads", name)
    config = _json("configs", spec["config"])
    traffic = _json("traffic", spec["traffic"])
    if dry_run:   # the CPU rehearsal's small sizes, from the cell's own file
        small = spec.get("dry_run", {})
        config = {**config, **small.get("config", {})}
        traffic = {**traffic, **small.get("traffic", {})}
        spec = {**spec, "check": {**spec.get("check", {}), **small.get("check", {})},
                "limits": {**spec.get("limits", {}), **small.get("limits", {})}}
    return Cell(name, spec, config, traffic)


def driver(name: str) -> ModuleType:
    return importlib.import_module(f"portbench.drivers.{name}")


def metric(name: str) -> Optional[ModuleType]:
    path = os.path.join(HERE, "metrics", f"{name}.py")
    if not os.path.isfile(path):
        return None
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark(root: str = ".") -> Dict[str, Any]:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def metrics_of(bench: Dict[str, Any], cell_name: str, kind: str):
    """The ``kind`` (``end_to_end`` / ``per_layer``) entries a cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell_name in m["workloads"]]
    if kind == "end_to_end":
        return e2e
    moves = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in moves)]
