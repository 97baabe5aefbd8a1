"""Thread-synchronization decorator — a copy of ``qst_tpu/utils/sync.py``.

Capability match for reference ``utils/synchronization.py:4-12``: attach one
``threading.Lock`` per decorated function so lazily-constructed shared
resources (model singletons, caches) initialize exactly once under
concurrency. The port's own singletons use explicit locks; this decorator is
the drop-in surface for user code. Host-only: numpy-free, torch-free."""

from __future__ import annotations

import functools
import threading
from typing import Callable, TypeVar

_F = TypeVar("_F", bound=Callable)


def synchronized(fn: _F) -> _F:
    lock = threading.Lock()

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with lock:
            return fn(*args, **kwargs)

    wrapper.__lock__ = lock  # type: ignore[attr-defined]
    return wrapper  # type: ignore[return-value]
