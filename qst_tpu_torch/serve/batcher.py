"""Dynamic micro-batching for single-device serving — a copy of
``qst_tpu/serve/batcher.py`` (standard library only).

Concurrent callers enqueue work items and a single collector thread drains
the queue into one batched call of up to ``max_batch`` items, waiting at most
``max_wait_s`` after the first item for stragglers. The code is the
source's; only docstrings and comments that spoke of the TPU changed, and
``tests/test_torch_ops.py`` holds the code to the source.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, List, Optional, Sequence


class _Item:
    """Future-like handle for one submitted payload."""

    __slots__ = ("payload", "event", "_result", "error")

    def __init__(self, payload):
        self.payload = payload
        self.event = threading.Event()
        self._result = None
        self.error: Optional[BaseException] = None

    def result(self) -> Any:
        """Block until the batched call resolves; raise its error if any."""
        self.event.wait()
        if self.error is not None:
            raise self.error
        return self._result


class DynamicBatcher:
    """Aggregate concurrent submissions into batched calls.

    Parameters
    ----------
    batch_fn : ``batch_fn(payloads: list) -> list`` — one result per payload,
        same order. With ``workers=1`` it runs on the single collector
        thread and needs no locking; with ``workers > 1`` it must be
        thread-safe (torch's CUDA launches are — and the GIL releases
        during host↔device copies, which is what the overlap exploits).
    max_batch : drain at most this many items per call.
    max_wait_s : after the first item arrives, wait at most this long for
        more before dispatching (latency bound under low load).
    workers : collector threads. One thread serializes the whole
        batch cycle — while batch N's device call + host materialization
        run, arrivals queue for batch N+1 and throughput caps at max
        realized batch / cycle time. Two workers keep a second batch in
        flight so transfers overlap device compute.
    finalize_fn : optional split-phase mode, ``finalize_fn(handle,
        payloads) -> list``. When given, ``batch_fn(payloads)`` is treated
        as a non-blocking DISPATCH (e.g. enqueue the device calls, return
        the in-flight device arrays) running on ONE collector thread —
        preserving device-call order — and ``finalize_fn`` (the blocking
        host materialization) runs on ``workers`` completer threads. The
        collector never blocks on a host transfer, so batch N+1 is
        collected and dispatched while batches N, N-1, … materialize —
        deeper overlap than plain ``workers=2``, whose each worker still
        serializes its own fetch before collecting again. In-flight
        batches are bounded (``2 × workers``) for backpressure.
    """

    def __init__(self, batch_fn: Callable[[List[Any]], Sequence[Any]],
                 max_batch: int = 64, max_wait_s: float = 0.005,
                 workers: int = 1,
                 finalize_fn: Optional[
                     Callable[[Any, List[Any]], Sequence[Any]]] = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {max_wait_s}")
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self._batch_fn = batch_fn
        self._finalize_fn = finalize_fn
        self._max_batch = max_batch
        self._max_wait_s = max_wait_s
        self._stats_lock = threading.Lock()
        self._n_batches = 0
        self._n_items = 0
        self._n_errors = 0
        self._max_seen = 0
        self._queue: "queue.Queue[Optional[_Item]]" = queue.Queue()
        if finalize_fn is None:
            self._done_queue = None
            self._threads = [threading.Thread(target=self._run, daemon=True)
                             for _ in range(workers)]
        else:
            # split-phase: 1 collector (ordered dispatch) + N completers;
            # the slot semaphore is the in-flight backpressure — acquired
            # BEFORE draining, so under saturation the collector sleeps
            # (no polling) while arrivals pile up and the next drain
            # realizes a LARGE batch (batch growth is the throughput
            # lever: a large search batch costs little more than a small one)
            self._done_queue: "queue.Queue" = queue.Queue()
            self._slots = threading.BoundedSemaphore(2 * workers)
            self._threads = [threading.Thread(target=self._run_dispatch,
                                              daemon=True)]
            self._threads += [
                threading.Thread(target=self._run_finalize, daemon=True)
                for _ in range(workers)]
        self._closed = False
        self._lifecycle = threading.Lock()  # orders submit vs close
        for t in self._threads:
            t.start()

    def submit_async(self, payload) -> _Item:
        """Enqueue without blocking; call ``.result()`` on the returned
        handle. Submitting a whole request's payloads before waiting lets
        them share one batch."""
        # The lock makes the closed-check + enqueue atomic w.r.t. close():
        # without it an item could slip in AFTER the close sentinel and
        # never be resolved, hanging its waiter forever.
        with self._lifecycle:
            if self._closed:
                raise RuntimeError("batcher is closed")
            item = _Item(payload)
            self._queue.put(item)
            return item

    def submit(self, payload) -> Any:
        """Block until the batched result for ``payload`` is available."""
        return self.submit_async(payload).result()

    def stats(self) -> dict:
        """Lifetime counters: batches dispatched, items served, realized
        mean/max batch size, batch_fn errors."""
        with self._stats_lock:
            n_b, n_i = self._n_batches, self._n_items
            return {
                "batches": n_b,
                "items": n_i,
                "mean_batch": round(n_i / n_b, 2) if n_b else 0.0,
                "max_batch": self._max_seen,
                "errors": self._n_errors,
            }

    def close(self) -> None:
        """Stop the collector threads (idempotent). In-flight items enqueued
        before close are still processed (FIFO: they precede the
        sentinels)."""
        with self._lifecycle:
            if self._closed:
                return
            self._closed = True
            # split-phase: only the single collector reads _queue; it
            # forwards sentinels to the completers itself
            n = 1 if self._finalize_fn is not None else len(self._threads)
            for _ in range(n):
                self._queue.put(None)
        for t in self._threads:
            t.join(timeout=5)

    def __enter__(self) -> "DynamicBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    def _drain(self, first: _Item) -> List[_Item]:
        import time

        items = [first]
        deadline = time.monotonic() + self._max_wait_s
        while len(items) < self._max_batch:
            # Sweep already-queued items unconditionally (even with
            # max_wait_s=0): work that piled up while the collector was
            # busy/blocked must coalesce into this batch — only waiting
            # for NOT-YET-ARRIVED stragglers is bounded by the deadline.
            try:
                nxt = self._queue.get_nowait()
            except queue.Empty:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=timeout)
                except queue.Empty:
                    break
            if nxt is None:         # close() sentinel: put it back and stop
                self._queue.put(None)
                break
            items.append(nxt)
        return items

    def _run(self) -> None:
        while True:
            first = self._queue.get()
            if first is None:
                return
            items = self._drain(first)
            with self._stats_lock:
                self._n_batches += 1
                self._n_items += len(items)
                self._max_seen = max(self._max_seen, len(items))
            try:
                results = self._batch_fn([it.payload for it in items])
                if len(results) != len(items):
                    raise RuntimeError(
                        f"batch_fn returned {len(results)} results for "
                        f"{len(items)} payloads")
                for it, res in zip(items, results):
                    it._result = res
            except BaseException as e:  # propagate to every waiter
                with self._stats_lock:
                    self._n_errors += 1
                for it in items:
                    it.error = e
            finally:
                for it in items:
                    it.event.set()

    # ------------------------- split-phase mode -----------------------
    def _resolve_error(self, items: List[_Item], e: BaseException) -> None:
        with self._stats_lock:
            self._n_errors += 1
        for it in items:
            it.error = e
            it.event.set()

    def _run_dispatch(self) -> None:
        """Single collector: drain → non-blocking dispatch → hand off."""
        n_completers = len(self._threads) - 1
        while True:
            first = self._queue.get()
            if first is None:
                # in-flight hand-offs precede these sentinels (FIFO), so
                # completers drain them before exiting
                for _ in range(n_completers):
                    self._done_queue.put(None)
                return
            # take an in-flight slot BEFORE draining: when every slot is
            # busy the device is the bottleneck, so the collector sleeps
            # here (zero CPU — no polling on a loaded host) while arrivals
            # keep queueing; the drain below then realizes them as one
            # large batch. When a slot is free this returns immediately
            # and latency is unchanged.
            self._slots.acquire()
            items = self._drain(first)
            with self._stats_lock:
                self._n_batches += 1
                self._n_items += len(items)
                self._max_seen = max(self._max_seen, len(items))
            try:
                handle = self._batch_fn([it.payload for it in items])
            except BaseException as e:
                self._slots.release()
                self._resolve_error(items, e)
                continue
            self._done_queue.put((handle, items))

    def _run_finalize(self) -> None:
        """Completer: blocking host materialization, off the collector."""
        while True:
            got = self._done_queue.get()
            if got is None:
                return
            handle, items = got
            try:
                results = self._finalize_fn(handle,
                                            [it.payload for it in items])
                if len(results) != len(items):
                    raise RuntimeError(
                        f"finalize_fn returned {len(results)} results "
                        f"for {len(items)} payloads")
            except BaseException as e:
                self._resolve_error(items, e)
                continue
            finally:
                self._slots.release()   # this in-flight batch is done
            for it, res in zip(items, results):
                it._result = res
                it.event.set()
