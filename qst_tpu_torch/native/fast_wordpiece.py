"""ctypes binding for the native batch WordPiece tokenizer — a copy of
``qst_tpu/native/fast_wordpiece.py``.

``FastWordPieceTokenizer`` is a drop-in replacement for
``qst_tpu_torch.models.tokenizer.WordPieceTokenizer`` whose ``batch_encode``
runs in C++ (multithreaded over the batch) for ASCII inputs and routes
non-ASCII strings through the Python implementation, so outputs are
bit-identical to the Python tokenizer everywhere (parity-tested). The class
and ``native_available`` are the source's code; the build differs in where
it puts the library: ``native/_build/libqst_wordpiece_<hash of the
source>.so``, written under a temporary name and renamed into place, so
processes that build at once never load a half-written file. This is a host
stage, not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from qst_tpu_torch.models.tokenizer import WordPieceTokenizer

logger = logging.getLogger("qst_tpu_torch.native")

_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_SRC_DIR, "wordpiece.cpp")
_BUILD_DIR = os.path.join(_SRC_DIR, "_build")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _lib_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libqst_wordpiece_{digest}.so")


def _build(out: str) -> bool:
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
           _SRC, "-o", tmp]
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
            OSError) as e:
        logger.warning("native wordpiece build failed (%s); using Python", e)
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        path = _lib_path()
        if not os.path.isfile(path):
            if not _build(path):
                _build_failed = True
                return None
        lib = ctypes.CDLL(path)
        lib.wp_create.restype = ctypes.c_void_p
        lib.wp_create.argtypes = [
            ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ]
        lib.wp_destroy.argtypes = [ctypes.c_void_p]
        lib.wp_batch_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


class FastWordPieceTokenizer(WordPieceTokenizer):
    """WordPieceTokenizer with a native batch_encode fast path."""

    def __init__(self, vocab: Dict[str, int], n_threads: int = 0, **kw):
        super().__init__(vocab, **kw)
        self._n_threads = n_threads or min(8, os.cpu_count() or 1)
        self._handle = None
        lib = _load()
        if lib is not None:
            tokens = sorted(vocab.items(), key=lambda kv: kv[1])
            blob = b"".join(t.encode("utf-8") + b"\0" for t, _ in tokens)
            self._blob = blob  # keep alive
            self._handle = lib.wp_create(
                blob, len(tokens), self.cls_id, self.sep_id, self.unk_id,
                self.pad_id, 1 if self.lowercase else 0,
                self.max_chars_per_word)
            self._lib = lib

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            try:
                self._lib.wp_destroy(handle)
            except Exception:
                pass

    def batch_encode(self, texts: Sequence[str], max_length: int = 128,
                     text_pairs=None) -> Tuple[np.ndarray, np.ndarray]:
        if self._handle is None or text_pairs is not None:
            return super().batch_encode(texts, max_length, text_pairs)
        n = len(texts)
        ids = np.empty((n, max_length), np.int32)
        mask = np.empty((n, max_length), np.int32)
        if n == 0:
            return ids, mask

        # ASCII fast path in C++; non-ASCII rows via the Python impl
        non_ascii: List[int] = []
        encoded: List[bytes] = []
        for i, t in enumerate(texts):
            try:
                encoded.append(t.encode("ascii"))
            except UnicodeEncodeError:
                encoded.append(b"")
                non_ascii.append(i)

        offsets = np.zeros(n + 1, np.int64)
        for i, b in enumerate(encoded):
            offsets[i + 1] = offsets[i] + len(b)
        buf = b"".join(encoded)

        self._lib.wp_batch_encode(
            self._handle, buf,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n, max_length, self._n_threads,
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))

        for i in non_ascii:
            row_ids, row_mask = super().batch_encode([texts[i]], max_length)
            ids[i], mask[i] = row_ids[0], row_mask[0]
        return ids, mask

    @classmethod
    def from_vocab_file(cls, path: str, **kw) -> "FastWordPieceTokenizer":
        vocab: Dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab, **kw)
