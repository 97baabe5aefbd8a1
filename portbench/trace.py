"""The traced window of a ``--trace 1`` run: ``torch.profiler`` over the
card and the host, the wrappers' launch counters read at both ends, and the
reductions the per-layer metrics and the ``breakdown`` read.

- ``busy_s``: the union of the device records' intervals (kernels, copies,
  sets), in seconds; ``window_s``: the window's length on the host clock.
- ``kernel_s``: device seconds by label (``kernels.label_kernels``; a
  record's launch is matched to the host's ``cudaGraphLaunch`` calls by its
  correlation id, so a graph's layer kernels are told from another
  thread's).
- ``gaps``: the idle intervals between device records, each named by the
  innermost host record (an operator or a ``record_function`` span) of the
  main thread that covers its middle, else by another thread's.
- ``shortfall``: for each kernel, the records a trace holds against the
  records its launches in the window must give (``kernels.ANCHORS``); a
  trace that lost records (kineto drops some late in long runs) would read
  the loss as idle time.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from portbench import kernels


WINDOW = "portbench.window"      # the span over the traced window, on the main thread


@dataclass
class Summary:
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]
    records: List[Tuple[str, str, float]]          # (name, label, seconds), time order
    gaps: List[Tuple[str, float]]                   # (host record, seconds), longest first
    launches: Dict[str, int]
    shortfall: Dict[str, int] = field(default_factory=dict)
    from_graph: int = 0                             # records a graph replay launched

    def seconds(self, label: str) -> float:
        return self.kernel_s.get(label, 0.0)


class Tracer:
    """``start()`` / ``stop()`` around the traced window; inert when off."""

    def __init__(self, enabled: bool, device: torch.device):
        self.enabled = enabled and device.type == "cuda"
        self.device = device
        self.summary: Optional[Summary] = None

    def start(self) -> None:
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(self.device)
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.start()
        # the counters after the trace starts and before it stops: a launch
        # from another thread at either end is then traced if it is counted
        self._launches = kernels.launches()
        self._span = torch.profiler.record_function(WINDOW)    # marks the main thread
        self._span.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if not self.enabled:
            return
        launched = kernels.delta(kernels.launches(), self._launches)
        torch.cuda.synchronize(self.device)
        window = time.perf_counter() - self._t0
        self._span.__exit__(None, None, None)
        self._prof.stop()
        self.summary = summarise(self._prof.events(), window, launched)
        del self._prof, self._span


def _union(intervals: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """(covered length, the idle gaps between covered stretches)."""
    total, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total, gaps


def summarise(events, window_s: float, launched: Dict[str, int]) -> Summary:
    device, host = [], []
    main = next((e.thread for e in events if e.name == WINDOW), None)
    graph_launches = {e.id for e in events
                      if e.device_type.name == "CPU" and "GraphLaunch" in e.name}
    for e in events:
        kind = e.device_type.name
        if kind == "CUDA":
            if getattr(e, "is_user_annotation", False):
                continue
            device.append((e.time_range.start, e.time_range.end, e.name, e.id in graph_launches))
        elif kind == "CPU" and e.name not in ("ProfilerStep*", WINDOW):
            host.append((e.time_range.start, e.time_range.end, e.name, e.thread))
    device.sort()
    labels = kernels.label_kernels([d[2] for d in device], [d[3] for d in device])
    from_graph = sum(d[3] for d in device)
    device = [d[:3] for d in device]
    kernel_s: Dict[str, float] = {}
    records = []
    for (s, e, name), label in zip(device, labels):
        kernel_s[label] = kernel_s.get(label, 0.0) + (e - s) * 1e-6
        records.append((name, label, (e - s) * 1e-6))
    busy_us, gap_spans = _union([(s, e) for s, e, _ in device])
    gaps = []
    for s, e in sorted(gap_spans, key=lambda g: g[0] - g[1])[:10]:
        mid = 0.5 * (s + e)
        cover = [h for h in host if h[0] <= mid <= h[1]]
        mine = [h for h in cover if h[3] == main]
        if mine:
            name = min(mine, key=lambda h: h[1] - h[0])[2]
        elif cover:
            name = "other thread: " + min(cover, key=lambda h: h[1] - h[0])[2]
        else:
            name = "main thread: no traced record"
        gaps.append((name, (e - s) * 1e-6))
    seen: Dict[str, int] = {}
    for _, _, name in device:
        base = kernels.base_name(name)
        for label, (names, _) in kernels.ANCHORS.items():
            if base in names:
                seen[label] = seen.get(label, 0) + 1
    shortfall = {}
    for label, (_, per) in kernels.ANCHORS.items():
        want = sum(n * launched.get(k, 0) for k, n in per.items())
        if want > seen.get(label, 0):
            shortfall[label] = want - seen.get(label, 0)
    return Summary(window_s=window_s, busy_s=busy_us * 1e-6, kernel_s=kernel_s,
                   records=records, gaps=gaps, launches=launched, shortfall=shortfall,
                   from_graph=from_graph)


def breakdown(summary: Summary) -> dict:
    """The contract's ``breakdown``: the ten largest device groups (the
    port's kernels by label, others by name) and the ten longest gaps."""
    groups: Dict[str, float] = {}
    for name, label, sec in summary.records:
        key = label if label.startswith("K") or label in ("optimizer", "memcpy", "memset") \
            else f"{label}: {short(name)}"
        groups[key] = groups.get(key, 0.0) + sec
    ops = sorted(groups.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in summary.gaps[:10]]}


def short(name: str) -> str:
    for noise in ("void ", "at::native::", "(anonymous namespace)::", "at::", "c10::"):
        name = name.replace(noise, "")
    return name[:80]
