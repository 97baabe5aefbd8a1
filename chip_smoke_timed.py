"""Run chip_smoke.py with each of its top-level functions timed: where its time goes.

    python3 chip_smoke_timed.py                      # every phase, as chip_smoke.py
    python3 chip_smoke_timed.py --phases build,pq    # chip_smoke.py's own arguments
    CHIP_SMOKE_TIMING_JSON=timing.json python3 chip_smoke_timed.py

Every log line of chip_smoke.py gets the seconds since the start in front of
it. At exit (also after a failed check) standard error gets each call path of
up to three of chip_smoke's functions (phase > part > helper) with its
inclusive wall time (host clock) and its number of calls, and the JSON file
named by $CHIP_SMOKE_TIMING_JSON, where set, the same table.
"""

from __future__ import annotations

import atexit
import functools
import inspect
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke  # noqa: E402

DEPTH = 3
T0 = time.perf_counter()
STACK: list = []
TIMES: dict = {}                 # "a > b > c" -> [seconds, calls]


def timed(name: str, fn):
    @functools.wraps(fn)
    def inner(*args, **kwargs):
        STACK.append(name)
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            # a recursive call is counted in its outermost frame only
            if len(STACK) <= DEPTH and name not in STACK[:-1]:
                rec = TIMES.setdefault(" > ".join(STACK), [0.0, 0])
                rec[0] += time.perf_counter() - t0
                rec[1] += 1
            STACK.pop()
    return inner


def report() -> None:
    rows = sorted(TIMES.items())
    print(f"chip_smoke by function (s, calls), {time.perf_counter() - T0:.1f} s in all:",
          file=sys.stderr)
    for path, (s, n) in rows:
        print(f"  {s:9.2f}  x{n:<5d} {path}", file=sys.stderr)
    out = os.environ.get("CHIP_SMOKE_TIMING_JSON")
    if out:
        with open(out, "w") as f:
            json.dump({p: {"s": s, "calls": n} for p, (s, n) in rows}, f, indent=1)


def main() -> None:
    for name, fn in list(vars(chip_smoke).items()):
        if (inspect.isfunction(fn) and fn.__module__ == chip_smoke.__name__
                and name not in ("main", "log", "fail")):
            setattr(chip_smoke, name, timed(name, fn))
    log = chip_smoke.log
    chip_smoke.log = lambda msg: log(f"[t={time.perf_counter() - T0:7.1f}] {msg}")
    atexit.register(report)
    sys.argv[0] = chip_smoke.__file__
    chip_smoke.main()


if __name__ == "__main__":
    main()
