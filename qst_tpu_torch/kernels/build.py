"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

All sources under ``kernels/csrc/`` compile into one shared library with a
plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o _build/libqst_kernels_<hash>.so csrc/*.cu

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
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

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


def build() -> Path:
    """Compile ``csrc/*.cu`` into the shared library unless it exists."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *[str(s) for s in _sources()]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent build sees all or nothing
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


def function(name: str, argtypes: Sequence[object]):
    """The C entry point ``name`` with its argument types declared
    (every pointer and the stream as ``c_void_p``) and an ``int`` result."""
    lib = load()
    with _lock:
        fn = _functions.get(name)
        if fn is None:
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _functions[name] = fn
        return fn


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = load().qst_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")
