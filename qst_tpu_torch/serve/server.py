"""Minimal HTTP serving front end — a copy of ``qst_tpu/serve/server.py``
over the port's ``qst_tpu_torch.retrieval.Retriever``.

Stdlib-only threading HTTP server:

- ``POST /search``   ``{"queries": [...], "k": 10, "return_texts": false}``
  → ``{"results": [[[doc_id, score(, text)], ...], ...]}``
- ``POST /encode``   ``{"texts": [...]}`` → ``{"embeddings": [[...], ...]}``
- ``GET  /healthz``  → ``{"ok": true, "n_docs": N}``
- ``GET  /stats``    → uptime, per-endpoint request counts, request
  latency p50/p95/p99 (ms, sliding window), and per-batcher counters
- ``POST /docs``     ``{"texts": [...], "ids": [...]}`` → ``{"ids": [...]}``
  and ``DELETE /docs`` ``{"ids": [...]}`` → ``{"removed": n}``, on a
  retriever backed by an ``UpdatableIndex`` (400 on a static index)

Concurrent requests are funneled through a :class:`DynamicBatcher` per
endpoint, so many small clients share one batched device call. What differs
from the source: the imports, and ``/encode`` copies device tensors to the
host with ``.cpu()``.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional, Tuple

import numpy as np
import torch

from qst_tpu_torch.retrieval.retriever import encode_keep_device
from qst_tpu_torch.serve.batcher import DynamicBatcher


class _Server(ThreadingHTTPServer):
    # stdlib default listen backlog is 5; a burst of N concurrent clients
    # (the DynamicBatcher's whole point) overflows it and resets
    # connections — seen as dropped clients at 64-way load
    # (benchmarks/serve_load_bench.py).
    request_queue_size = 1024


class RetrievalServer:
    """Wrap a built/loaded ``Retriever`` in an HTTP server.

    Call :meth:`start` (non-blocking; returns the bound port), then
    :meth:`stop`. ``k_max`` caps per-request k.
    """

    def __init__(self, retriever: Any, host: str = "127.0.0.1",
                 port: int = 0, max_batch: int = 256,
                 max_wait_s: float = 0.005, k_max: int = 128,
                 workers: int = 2):
        if retriever.index is None:
            raise ValueError("retriever has no index (build() or load() it)")
        self.retriever = retriever
        self._host, self._port = host, port
        self._k_max = k_max
        self._max_batch = max_batch
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        # one batcher per endpoint: payloads are (query, k, return_texts)
        # tuples for search, raw texts for encode; workers > 1 keeps a
        # second batch in flight so host transfers overlap device compute
        # (see DynamicBatcher docs)
        # split-phase batchers: the collector thread only DISPATCHES the
        # device calls (tokenize + encode + search, all non-blocking under
        # CUDA's asynchronous launches) and `workers` completer threads block on the
        # host materialization — batch N+1 is collected and dispatched
        # while batch N's results transfer, instead of the encode call
        # serializing behind the previous batch's fetch
        self._search_batcher = DynamicBatcher(
            self._search_dispatch, max_batch=max_batch,
            max_wait_s=max_wait_s, workers=workers,
            finalize_fn=self._search_finalize)
        self._encode_batcher = DynamicBatcher(
            self._encode_dispatch, max_batch=max_batch,
            max_wait_s=max_wait_s, workers=workers,
            finalize_fn=self._encode_finalize)
        # serializes /docs writers (UpdatableIndex updates are lock-free
        # vs concurrent readers but not vs each other)
        self._write_lock = threading.Lock()
        # observability: request counts + a sliding latency window
        self._started_at = time.monotonic()
        self._stats_lock = threading.Lock()
        self._req_counts: dict = {}
        self._latencies: "deque[float]" = deque(maxlen=4096)

    # ---------------- batched device calls (collector threads) ----------
    @staticmethod
    def _bucket(n: int, hi: int) -> int:
        """Round n up to a power of two in [8, hi]: the query-batch size and
        k are padded to a small static set of shapes, as in the source,
        where every distinct shape costs a fresh compile."""
        b = 8
        while b < n:
            b *= 2
        return min(b, hi)

    def _search_dispatch(self, payloads):
        # one device call for the union of queries; batch and k bucketed
        # to compile-stable shapes, trimmed per payload in the finalizer
        queries = [p[0] for p in payloads]
        k = self._bucket(max(p[1] for p in payloads), self._k_max)
        B = self._bucket(len(queries), self._max_batch)
        padded = queries + [queries[0]] * (B - len(queries))
        want_texts = any(p[2] for p in payloads)
        finish = self.retriever.search_async(padded, k=k,
                                             return_texts=want_texts)
        return finish, want_texts

    def _search_finalize(self, handle, payloads):
        finish, want_texts = handle
        rows = finish()     # blocks on the device→host transfer
        out = []
        for (q, kk, rt), row in zip(payloads, rows):
            row = row[: min(kk, len(row))]
            if want_texts and not rt:
                row = [r[:2] for r in row]
            out.append(row)
        return out

    def _encode_dispatch(self, texts):
        # pad to bucketed shapes, as the source does (SentenceEncoder
        # buckets internally, so the pad collapses to the same shape)
        B = self._bucket(len(texts), self._max_batch)
        padded = list(texts) + [texts[0]] * (B - len(texts))
        # keep on device when the encoder supports it: the dispatch phase
        # must not block on the embedding download
        return encode_keep_device(self.retriever.encoder.encode, padded)

    def _encode_finalize(self, emb, texts):
        emb = (emb.float().cpu().numpy() if isinstance(emb, torch.Tensor)
               else np.asarray(emb))
        return [emb[i].tolist() for i in range(len(texts))]

    # ---------------- lifecycle ----------------------------------------
    def start(self) -> int:
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def _reply(self, code: int, obj) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply(200, {"ok": True,
                                      "n_docs": server.retriever.index.n_docs})
                elif self.path == "/stats":
                    self._reply(200, server._stats())
                else:
                    self._reply(404, {"error": "unknown path"})

            def _body(self):
                n = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(n) or b"{}")

            def do_POST(self):
                try:
                    req = self._body()
                except (ValueError, json.JSONDecodeError):
                    self._reply(400, {"error": "invalid JSON"})
                    return
                try:
                    if self.path == "/search":
                        self._reply(200, server._observed(
                            "search", lambda: server._handle_search(req)))
                    elif self.path == "/encode":
                        self._reply(200, server._observed(
                            "encode", lambda: server._handle_encode(req)))
                    elif self.path == "/docs":
                        self._reply(200, server._observed(
                            "add_docs",
                            lambda: server._handle_add_docs(req)))
                    else:
                        self._reply(404, {"error": "unknown path"})
                except (ValueError, KeyError) as e:
                    self._reply(400, {"error": str(e)})
                except Exception as e:   # device/runtime failure
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})

            def do_DELETE(self):
                try:
                    req = self._body()
                except (ValueError, json.JSONDecodeError):
                    self._reply(400, {"error": "invalid JSON"})
                    return
                try:
                    if self.path == "/docs":
                        self._reply(200, server._observed(
                            "remove_docs",
                            lambda: server._handle_remove_docs(req)))
                    else:
                        self._reply(404, {"error": "unknown path"})
                except (ValueError, KeyError) as e:
                    self._reply(400, {"error": str(e)})
                except Exception as e:
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        self._httpd = _Server((self._host, self._port), Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self._httpd.server_address[1]

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        self._search_batcher.close()
        self._encode_batcher.close()

    # ---------------- observability -------------------------------------
    def _observed(self, name: str, fn):
        """Count the request and record its wall latency (successful or
        not) in the sliding window."""
        t0 = time.perf_counter()
        try:
            return fn()
        finally:
            dt = time.perf_counter() - t0
            with self._stats_lock:
                self._req_counts[name] = self._req_counts.get(name, 0) + 1
                self._latencies.append(dt)

    def _stats(self) -> dict:
        with self._stats_lock:
            lat = sorted(self._latencies)
            counts = dict(self._req_counts)

        def pct(p: float):
            if not lat:
                return None
            return round(
                lat[min(len(lat) - 1, int(p / 100 * len(lat)))] * 1e3, 2)

        return {
            "uptime_s": round(time.monotonic() - self._started_at, 1),
            "n_docs": self.retriever.index.n_docs,
            "requests": counts,
            "latency_ms": {"p50": pct(50), "p95": pct(95), "p99": pct(99),
                           "window": len(lat)},
            "batchers": {"search": self._search_batcher.stats(),
                         "encode": self._encode_batcher.stats()},
        }

    # ---------------- request handlers (server threads) -----------------
    def _handle_search(self, req) -> dict:
        queries, k, rt = self._validate_search(req)
        # enqueue every query BEFORE waiting so one request's queries share
        # a batch (and interleave with concurrent requests')
        futs = [self._search_batcher.submit_async((q, k, rt))
                for q in queries]
        return {"results": [f.result() for f in futs]}

    @staticmethod
    def _valid_ids(ids) -> bool:
        return (isinstance(ids, list)
                and all(isinstance(i, (str, int))
                        and not isinstance(i, bool) for i in ids))

    def _require_updatable(self, action: str) -> None:
        if not getattr(self.retriever, "_is_updatable", lambda: False)():
            raise ValueError(
                "index is static — serve a Retriever.build_updatable() "
                f"retriever to {action} documents online")

    def _handle_add_docs(self, req) -> dict:
        texts = req.get("texts")
        if (not isinstance(texts, list) or not texts
                or not all(isinstance(t, str) for t in texts)):
            raise ValueError("'texts' must be a non-empty list of strings")
        ids = req.get("ids")
        if ids is not None and (not self._valid_ids(ids)
                                or len(ids) != len(texts)):
            raise ValueError(
                "'ids' must be a list of strings/ints matching 'texts'")
        self._require_updatable("add")
        with self._write_lock:
            out = self.retriever.add_docs(texts, ids)
        return {"ids": list(out)}

    def _handle_remove_docs(self, req) -> dict:
        ids = req.get("ids")
        if not ids or not self._valid_ids(ids):
            raise ValueError("'ids' must be a non-empty list of "
                             "strings/ints")
        self._require_updatable("remove")
        with self._write_lock:
            self.retriever.remove_docs(ids)
        return {"removed": len(ids)}

    def _handle_encode(self, req) -> dict:
        texts = req.get("texts")
        if (not isinstance(texts, list) or not texts
                or not all(isinstance(t, str) for t in texts)):
            raise ValueError("'texts' must be a non-empty list of strings")
        futs = [self._encode_batcher.submit_async(t) for t in texts]
        return {"embeddings": [f.result() for f in futs]}

    def _validate_search(self, req) -> Tuple[list, int, bool]:
        queries = req.get("queries")
        if (not isinstance(queries, list) or not queries
                or not all(isinstance(q, str) for q in queries)):
            raise ValueError("'queries' must be a non-empty list of strings")
        k = req.get("k", 10)
        # bool subclasses int: true would silently mean k=1
        if (not isinstance(k, int) or isinstance(k, bool)
                or not 1 <= k <= self._k_max):
            raise ValueError(f"'k' must be an int in [1, {self._k_max}]")
        want_texts = bool(req.get("return_texts", False))
        if want_texts and not (
                getattr(self.retriever, "_doc_texts", None)
                or getattr(self.retriever, "_texts_by_id", None)):
            raise ValueError(
                "'return_texts' requested but the index was loaded without "
                "document texts")
        return queries, k, want_texts
