"""Telemetry: the JSON result log and step timing — counterpart of
``qst_tpu/core/telemetry.py`` (``JsonLogSink``, ``StepTimer``).

``JsonLogSink`` is a host copy. ``StepTimer`` differs only in its device
hooks: each phase is a ``torch.profiler.record_function`` span (so it shows
in a profiler trace, as ``jax.profiler.TraceAnnotation`` did), and ``sync``
— a tensor the phase produced — waits for its CUDA device before the clock
stops, as ``jax.block_until_ready`` did.
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from typing import Any, Dict, List

import torch


class JsonLogSink:
    """Cumulative JSON-array log (load, append, rewrite) — same on-disk shape
    as the reference's ``_quadruplet_loss_eval.json`` (evaluators.py:106-125).
    """

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def append(self, entry: Dict[str, Any]) -> None:
        entries: List[Dict[str, Any]] = []
        if os.path.isfile(self.path):
            try:
                with open(self.path) as f:
                    entries = json.load(f)
            except (json.JSONDecodeError, OSError):
                entries = []
        entries.append(entry)
        with open(self.path, "w") as f:
            json.dump(entries, f, indent=2)

    def read(self) -> List[Dict[str, Any]]:
        if not os.path.isfile(self.path):
            return []
        with open(self.path) as f:
            return json.load(f)


class StepTimer:
    """Wall-clock phase timing with running means; device-synchronized."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextmanager
    def phase(self, name: str, sync: Any = None):
        with torch.profiler.record_function(name):
            t0 = time.perf_counter()
            yield
            if isinstance(sync, torch.Tensor) and sync.device.type == "cuda":
                torch.cuda.synchronize(sync.device)
            dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def mean(self, name: str) -> float:
        c = self.counts.get(name, 0)
        return self.totals.get(name, 0.0) / c if c else 0.0

    def summary(self) -> Dict[str, float]:
        return {k: self.mean(k) for k in self.totals}
