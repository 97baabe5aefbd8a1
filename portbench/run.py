"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and ``qst_tpu_torch/``, on a machine with the cards the cell asks for.
``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a traced window. The last line of standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` (and with ``--trace 1`` ``breakdown``), then ``checks``, each
number compared with its limit, which also close standard error.

``--control 1`` also computes the lower-precision control's readings of the
same numbers (``control``); ``--dry-run`` runs the cell at its file's small
sizes on the CPU, without the card (the tests' rehearsal).

Exits non-zero, printing no result, without the cards the cell asks for,
and when ``jax``, ``jaxlib``, ``flax``, ``optax`` or ``qst_tpu`` is loaded
once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

BANNED = ("jax", "jaxlib", "flax", "optax", "qst_tpu")


def banned_modules(modules=None):
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole (``qst_tpu_torch`` is not ``qst_tpu``)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(BANNED))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    p.add_argument("--dry-run", action="store_true")
    return p.parse_args(argv)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None) -> int:
    from portbench.harness import process_age_s

    started = time.time() - process_age_s()
    args = parse(argv)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    import torch

    early = [("python and torch", time.time())]
    from portbench import registry
    from portbench.harness import Run
    from portbench.trace import breakdown

    bench = registry.benchmark()
    cell = registry.cell(args.workload, dry_run=args.dry_run)
    chips = int(cell.spec.get("chips", 1))
    if args.dry_run:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"portbench: {args.workload} needs {chips} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)
        early.append(("cuda", time.time()))
    run = Run(cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
              control=bool(args.control), dry_run=args.dry_run, started=started, device=device,
              phases=early)
    out = registry.driver(cell.driver).run(run)

    loaded = banned_modules()
    if loaded:
        print(f"portbench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3

    last = run.started
    for phase, at in run.phases:
        print(f"set-up {phase}: {at - last:.3f} s", file=sys.stderr)
        last = at
    checks = list(out.checks)
    from portbench.harness import Check

    main_path = [k for k in cell.spec.get("main_kernels", []) if out.launched.get(k, 0) <= 0]
    if not args.dry_run:   # the plain CPU paths count no launches
        checks.append(Check("main_path_kernels_missing", float(len(main_path)), 0.0))
    correct = all(c.ok for c in checks)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    metrics = {}
    if not args.trace:
        for m in registry.metrics_of(bench, cell.name, "end_to_end"):
            v = out.setup_s if m["name"] == "setup_s" else out.e2e.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        observed = dict(out.observed, device_name=name, cfg=cell.config, trace=out.trace)
        for m in registry.metrics_of(bench, cell.name, "per_layer"):
            reader = registry.metric(m["name"])
            v = None if reader is None else reader.read(observed)
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": name,
                         "count": chips, "memory_peak_bytes": out.memory_peak_bytes}}
    if device.type == "cuda":
        result["device"]["power_limit"] = power_limit()
    if args.trace and out.trace is not None:
        result["device"]["busy_s"] = out.trace.busy_s
        result["device"]["window_s"] = out.trace.window_s
        result["breakdown"] = breakdown(out.trace)
        if out.trace.shortfall:
            print(f"portbench: the trace lost device records (kernel: records missing): "
                  f"{out.trace.shortfall}", file=sys.stderr)
        result["trace_records_missing"] = out.trace.shortfall
        print(f"trace: {len(out.trace.records)} device records, {out.trace.from_graph} of them "
              f"launched by a CUDA graph replay", file=sys.stderr)
    if out.control:
        result["control"] = out.control
        print("control: " + ", ".join(f"{k} {v!r}" for k, v in out.control.items()),
              file=sys.stderr)
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    for c in checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}){'' if c.ok else ' FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
