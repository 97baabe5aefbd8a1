"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

All sources under ``kernels/csrc/`` compile into one shared library with a
plain C interface: one ``nvcc -c`` per source, all started together, then
one link::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \\
         -c csrc/<name>.cu -o _build/<hash>/<name>.o          # each source at once
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \\
         -o _build/libqst_kernels_<hash>.so _build/<hash>/*.o -ldl

The library is built at first use into ``kernels/_build/`` (listed in
``.gitignore``), named by a hash of the sources and flags, so a checkout
builds everything from its own sources and an edit rebuilds. A failed build
raises with nvcc's stderr; a build that succeeds keeps ptxas's report of
each kernel's registers, shared memory and spills (``-Xptxas -v``) beside the
library (``resource_report``). Nothing here runs at import time.

Each C entry point returns a ``cudaError_t`` (0 on success); ``check``
raises on anything else with CUDA's own message.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes of the C entry points (csrc/common.cuh QstDType)
DTYPE_CODES = {"float32": 0, "bfloat16": 1, "int8": 2}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_functions: Dict[str, object] = {}


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels are built from "
            f"{CSRC} at first use on a machine with the CUDA toolkit")
    return found


def _sources() -> Sequence[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for flag in NVCC_FLAGS:
        h.update(flag.encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libqst_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: Sequence[Sequence[str]]) -> str:
    """Run the commands at once → their output (ptxas reports on either
    stream), joined; raise with every failure's stderr."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    failed, errs = [], []
    for cmd, proc in zip(cmds, procs):
        out, err = proc.communicate()
        errs.append(out + err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(errs)


def build() -> Path:
    """Compile ``csrc/*.cu`` into the shared library unless it exists."""
    out = library_path()
    if out.is_file():
        return out
    nvcc = _nvcc()
    objdir = BUILD_DIR / f"{out.stem}.{os.getpid()}"
    objdir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        objs = [objdir / f"{src.stem}.o" for src in _sources()]
        report = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                           for src, obj in zip(_sources(), objs)])
        _run_all([[nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs), "-ldl"]])
        out.with_suffix(".ptxas.txt").write_text(report)
        os.replace(tmp, out)   # atomic: a concurrent build sees all or nothing
    finally:
        shutil.rmtree(objdir, ignore_errors=True)
        tmp.unlink(missing_ok=True)
    return out


def resource_report(kernel: str) -> Dict[str, str]:
    """{mangled name: ptxas's lines} of every compiled kernel whose name holds
    ``kernel``, from the built library's report (registers, barriers,
    shared memory, stack frame, spills, and ptxas's notes where it had to
    serialise a kernel's wgmma)."""
    path = library_path().with_suffix(".ptxas.txt")
    out: Dict[str, str] = {}
    name = None
    for line in path.read_text().splitlines() if path.is_file() else ():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else None
        elif name is not None and kernel in name and (
                "Used" in line or "spill" in line or "stack frame" in line
                or "Performance Loss" in line):
            out[name] = (out.get(name, "") + " " + line.split(":", 1)[-1].strip()).strip()
    return out


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
            _lib.qst_error_string.argtypes = [ctypes.c_int]
            _lib.qst_error_string.restype = ctypes.c_char_p
        return _lib


def function(name: str, argtypes: Sequence[object], restype: object = ctypes.c_int):
    """The C entry point ``name`` with its argument types declared
    (every pointer and the stream as ``c_void_p``) and its result type
    (``int``: a cudaError_t)."""
    lib = load()
    with _lock:
        fn = _functions.get(name)
        if fn is None:
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = restype
            _functions[name] = fn
        return fn


def device_guard(device):
    """A context in which ``device`` is the current CUDA device, as a launch
    needs it; where it already is (the usual case) the context does nothing
    and costs nothing."""
    import contextlib

    import torch

    if torch.cuda.current_device() == device.index:
        return contextlib.nullcontext()
    return torch.cuda.device(device)


_count_lock = threading.Lock()
_captured: Optional[Dict[object, int]] = None   # launches recorded into a CUDA graph


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, the count of its kernel's launches,
    under a lock: an encode on a data-loading thread (the negative miner)
    launches K1 while the main thread runs train steps. A call made while
    its stream is being captured into a CUDA graph launches nothing: inside
    ``capturing_launches`` it is recorded there instead, and
    ``add_launches`` counts the recording once per replay."""
    with _count_lock:
        if _captured is not None:
            import torch

            if torch.cuda.is_current_stream_capturing():
                _captured[wrapper] = _captured.get(wrapper, 0) + 1
                return
        wrapper.launches += 1


class capturing_launches:
    """``with capturing_launches() as rec:`` around a graph capture → ``rec``,
    {wrapper: the launches each replay of the graph makes}. Calls on other
    streams (a miner's encode on another thread) still count as launches."""

    def __enter__(self) -> Dict[object, int]:
        global _captured
        with _count_lock:
            if _captured is not None:
                raise RuntimeError("one graph capture at a time")
            _captured = {}
            return _captured

    def __exit__(self, *exc) -> bool:
        global _captured
        with _count_lock:
            _captured = None
        return False


def add_launches(recorded: Dict[object, int]) -> None:
    """Count one replay of a graph whose capture recorded ``recorded``."""
    with _count_lock:
        for wrapper, n in recorded.items():
            wrapper.launches += n


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = load().qst_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")
