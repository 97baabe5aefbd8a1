"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

All sources under ``kernels/csrc/`` compile into one shared library with a
plain C interface: one ``nvcc -c`` per source, all started together, then
one link::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \\
         -c csrc/<name>.cu -o _build/<hash>/<name>.o          # each source at once
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \\
         -o _build/libqst_kernels_<hash>.so _build/<hash>/*.o

The library is built at first use into ``kernels/_build/`` (listed in
``.gitignore``), named by a hash of the sources and flags, so a checkout
builds everything from its own sources and an edit rebuilds. A failed build
raises with nvcc's stderr. Nothing here runs at import time.

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
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

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


def _run_all(cmds: Sequence[Sequence[str]]) -> None:
    """Run the commands at once; raise with the first failure's stderr."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


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
        _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                  for src, obj in zip(_sources(), objs)])
        _run_all([[nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, out)   # atomic: a concurrent build sees all or nothing
    finally:
        shutil.rmtree(objdir, ignore_errors=True)
        tmp.unlink(missing_ok=True)
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


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = load().qst_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")
