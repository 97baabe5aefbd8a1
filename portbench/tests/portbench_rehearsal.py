"""A cell's rehearsal on the CPU at its file's small sizes, run in this
process (``portbench.run --dry-run``)."""

from __future__ import annotations

import contextlib
import io
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELLS = ("minilm_l6.train_b32", "mpnet_base.encode_long")


def rehearse(cell: str, seed: int = 2200000123, seconds: float = 1.0, trace: int = 0,
             control: int = 0, root: str = ROOT) -> dict:
    """``portbench.run`` on ``cell`` with ``--dry-run`` → its last line, parsed."""
    from portbench import run

    out = io.StringIO()
    cwd = os.getcwd()
    os.chdir(root)
    try:
        with contextlib.redirect_stdout(out):
            rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                           "--trace", str(trace), "--control", str(control), "--dry-run"])
    finally:
        os.chdir(cwd)
    assert rc == 0, out.getvalue()
    return json.loads(out.getvalue().strip().splitlines()[-1])
