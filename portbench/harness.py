"""What every traffic driver shares: the run's context, its outcome, the window's
clock, and the observation proxies the harness puts around objects it hands
the program.

A traffic driver builds the program's objects from the cell, warms up the shapes
its traffic uses, measures for ``run.seconds`` on the host clock (a window
that ends in ``torch.cuda.synchronize``), then frees the program's state
and has the reference judge a sample of what the window produced.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Collection, Dict, List, Optional

import numpy as np
import torch

from portbench import kernels
from portbench.registry import Cell
from portbench.trace import Summary, Tracer


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc/self/stat against
    /proc/uptime)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.value)) and self.value <= self.limit


@dataclass
class Run:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    control: bool
    dry_run: bool
    started: float                    # time.time() at process start
    device: torch.device = None
    phases: List[tuple] = field(default_factory=list)

    def phase(self, name: str) -> None:
        """Mark the end of a set-up phase (printed on standard error)."""
        self.phases.append((name, time.time()))

    @property
    def cfg(self) -> Dict[str, Any]:
        return self.cell.config

    @property
    def traffic(self) -> Dict[str, Any]:
        return self.cell.traffic

    @property
    def check(self) -> Dict[str, Any]:
        return self.cell.spec.get("check", {})

    def limit(self, name: str) -> float:
        return float(self.cell.spec["limits"][name])

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def tracer(self) -> Tracer:
        return Tracer(self.trace, self.device)


@dataclass
class Outcome:
    attempted: int
    failed: int
    e2e: Dict[str, float]
    setup_s: float
    memory_peak_bytes: int
    checks: List[Check]
    launched: Dict[str, int]                      # the window's launches by label
    observed: Dict[str, Any] = field(default_factory=dict)
    trace: Optional[Summary] = None
    control: Dict[str, float] = field(default_factory=dict)


class Window:
    """The measured window's clock; ``setup_s`` is process start to its start."""

    def __init__(self, run: Run):
        self.run = run

    def start(self) -> None:
        self.run.sync()
        self.launches = kernels.launches()
        self.setup_s = time.time() - self.run.started
        self.t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def stop(self) -> float:
        self.run.sync()
        self.seconds = time.perf_counter() - self.t0
        self.launched = kernels.delta(kernels.launches(), self.launches)
        return self.seconds


def spanned(fn, name: str):
    """``fn`` inside a ``record_function`` span: the benchmark's own span
    around a call into one of the program's layers."""
    def call(*a, **kw):
        with torch.profiler.record_function(name):
            return fn(*a, **kw)

    return call


def peak_memory(run: Run) -> int:
    if run.device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(run.device))


def free_program_memory(run: Run) -> None:
    import gc

    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
        torch.cuda.empty_cache()


class TokenizerProbe:
    """Stands in for the tokenizer the harness hands the program: times each
    ``batch_encode`` on the host and counts the real tokens it returns, the
    call's end stamped (``record``: the numbers of the calls, from 0, whose
    texts it also keeps). Calls may come from several threads."""

    def __init__(self, inner: Any, record: Collection[int] = ()):
        self.inner = inner
        self.calls = 0
        self.seconds = 0.0
        self.real_lengths: List[np.ndarray] = []
        self.stamps: List[float] = []
        self.recorded: Dict[int, List[str]] = {}
        self._record = set(record)
        self._lock = threading.Lock()

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def batch_encode(self, texts, max_length: int = 128, *a, **kw):
        t0 = time.perf_counter()
        with torch.profiler.record_function("portbench.tokenize"):
            ids, mask = self.inner.batch_encode(texts, max_length, *a, **kw)
        t1 = time.perf_counter()
        with self._lock:
            self.calls += 1
            self.seconds += t1 - t0
            self.real_lengths.append(mask.sum(axis=1))
            self.stamps.append(t1)
            if self.calls - 1 in self._record:
                self.recorded[self.calls - 1] = list(texts)
        return ids, mask

    def mark(self):
        with self._lock:
            return self.calls, self.seconds, len(self.real_lengths)

    def between(self, t0: float, t1: float):
        """(the real lengths, the number of calls) of the calls that ended in
        [t0, t1] on the host clock (``time.perf_counter``)."""
        with self._lock:
            picked = [ln for ln, t in zip(self.real_lengths, self.stamps) if t0 <= t <= t1]
        return (np.concatenate(picked) if picked else np.zeros(0, np.int64)), len(picked)


