"""Telemetry: the CSV and JSON result logs and step timing — counterpart of
``qst_tpu/core/telemetry.py`` (``CsvSink``, ``JsonLogSink``, ``StepTimer``).

``CsvSink`` and ``JsonLogSink`` are host copies. ``StepTimer`` differs only in its device
hooks: each phase is a ``torch.profiler.record_function`` span (so it shows
in a profiler trace, as ``jax.profiler.TraceAnnotation`` did), and ``sync``
— a tensor the phase produced — waits for its CUDA device before the clock
stops, as ``jax.block_until_ready`` did. ``profile_trace`` takes
``torch.profiler`` where the source starts ``jax.profiler``'s trace.
"""

from __future__ import annotations

import csv
import json
import os
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Sequence

import torch


class CsvSink:
    """Append-only CSV results file with a fixed header (written once)."""

    def __init__(self, path: str, header: Sequence[str]):
        self.path = path
        self.header = list(header)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        if not os.path.isfile(path):
            with open(path, "w", newline="") as f:
                csv.writer(f).writerow(self.header)

    def append(self, row: Sequence[Any]) -> None:
        with open(self.path, "a", newline="") as f:
            csv.writer(f).writerow(list(row))


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


@contextmanager
def profile_trace(log_dir: Optional[str]):
    """Optionally capture a ``torch.profiler`` trace around a block (the
    source's ``jax.profiler`` trace, ``qst_tpu/core/telemetry.py:96-105``):
    host activity, and the CUDA device's where one is present, written as a
    Chrome trace ``trace_<pid>_<ns>.json`` into ``log_dir`` when the block
    ends, also when it raises. Yields the profiler (None without a
    ``log_dir``)."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
