"""Native (C++) host components of the port, bound via ctypes — a copy of
``qst_tpu/native``.

Built on demand with g++ (no pip, no pybind11): the first use compiles
``wordpiece.cpp`` into ``native/_build/`` (listed in ``.gitignore``, named by
a hash of the source); a failed build degrades to the pure-Python tokenizer.
"""

from qst_tpu_torch.native.fast_wordpiece import (
    FastWordPieceTokenizer,
    native_available,
)

__all__ = ["FastWordPieceTokenizer", "native_available"]
