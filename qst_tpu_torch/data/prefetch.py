"""Background-thread input prefetching — a host copy of
``qst_tpu/data/prefetch.py`` (``tests/test_torch_data.py`` holds it to its
source).

The reference's input pipeline is synchronous (`DataLoader(num_workers=0)`,
reference training/main.py:43) AND runs model inference per item. Here
sampling + mining + collation for batch N+1 runs on a host thread while the
device executes step N — the host work hides behind the device step entirely
once steady-state is reached.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, Optional

_SENTINEL = object()


class PrefetchIterator:
    """Wrap a batch iterator: a daemon thread stays ``depth`` batches ahead.

    Exceptions in the producer are re-raised in the consumer. The producer
    can be stopped early with :meth:`close` (e.g. on early stopping).
    """

    def __init__(self, source: Iterator[Any],
                 transform: Optional[Callable[[Any], Any]] = None,
                 depth: int = 2):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, {depth} given")
        self._queue: "queue.Queue[Any]" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None

        def producer():
            try:
                for item in source:
                    if self._stop.is_set():
                        return
                    if transform is not None:
                        item = transform(item)
                    while not self._stop.is_set():
                        try:
                            self._queue.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
            except BaseException as e:  # surfaced on the consumer side
                self._error = e
            finally:
                while not self._stop.is_set():
                    try:
                        self._queue.put(_SENTINEL, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        self._thread = threading.Thread(target=producer, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            try:
                item = self._queue.get(timeout=1.0)
                break
            except queue.Empty:
                if self._error is not None:
                    raise self._error
                if not self._thread.is_alive():
                    raise StopIteration
        if item is _SENTINEL:
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
