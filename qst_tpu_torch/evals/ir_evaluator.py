"""Information-retrieval evaluator — counterpart of
``qst_tpu/evals/ir_evaluator.py``.

Capability match for sentence-transformers' ``InformationRetrievalEvaluator``
as configured by the reference (ir_evauation_script.py:107-123: queries /
corpus / relevant dicts, corpus_chunk_size, the full @k metric grid, multiple
score functions, CSV output) on the port's retrieval: one batched corpus
encode into an ``ExactIndex`` that stays on the encoder's device, one top-k
search per score function, pure-function metrics on the host.

The index's own rule picks the search: K4 + K5 (``ops/topk.py``) for cos /
dot searches with k ≤ 128 over ≥ 65,536 documents on a GPU, else the plain
scan — with the default metric grid (largest k 900) always the scan, as in
the JAX package.

Main score follows sentence-transformers: the best ``map@max(map_at_k)``
across score functions (so A/B comparisons against reference runs use the
same scalar).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional, Sequence, Set

import numpy as np

from qst_tpu_torch.core.config import IREvalConfig
from qst_tpu_torch.core.telemetry import CsvSink
from qst_tpu_torch.evals.ir_metrics import ir_metrics
from qst_tpu_torch.retrieval.index import ExactIndex
from qst_tpu_torch.retrieval.retriever import encode_keep_device

EncodeFn = Callable[[Sequence[str]], np.ndarray]


class InformationRetrievalEvaluator:
    def __init__(
        self,
        queries: Dict[str, str],
        corpus: Dict[str, str],
        relevant: Dict[str, Set[str]],
        cfg: Optional[IREvalConfig] = None,
        mesh=None,
        log_dir: Optional[str] = None,
        name: str = "ir",
        cache_corpus_index: bool = False,
        index_factory: Optional[Callable] = None,
        device: Any = None,
    ):
        """``cache_corpus_index=True`` builds the corpus index ONCE and
        reuses it across ``__call__``s — only valid when the encoder is
        frozen between calls (repeated evaluation of one model over many
        query sets / epochs of an unchanged baseline); during training the
        corpus embeddings change every call, so the default rebuilds.

        ``index_factory(embeddings, ids, mesh) -> index`` swaps the exact
        index for another family (``IVFIndex``, an int8 ``ExactIndex``),
        so approximate-index recall loss is measurable directly on the
        FULL IR metric grid. Approximate indexes score cos/dot only;
        restrict ``cfg.score_functions`` accordingly.

        ``device``: where the index lives when the encode function returns
        host arrays (default: the GPU); a function that returns tensors
        (``SentenceEncoder.encode``) keeps them on its own device."""
        cfg = cfg or IREvalConfig()
        self._cache_corpus_index = cache_corpus_index
        self._index_factory = index_factory
        self._index: Optional[ExactIndex] = None
        self.device = device
        # keep only queries that have at least one relevant doc
        self.query_ids = [q for q in queries if relevant.get(q)]
        if not self.query_ids:
            raise ValueError("no queries with non-empty relevant sets")
        self.queries = [queries[q] for q in self.query_ids]
        self.corpus_ids = list(corpus.keys())
        self.corpus_texts = [corpus[c] for c in self.corpus_ids]
        self.relevant = {q: set(relevant[q]) for q in self.query_ids}
        self.cfg = cfg
        self.mesh = mesh
        self.max_k = max(
            (*cfg.accuracy_at_k, *cfg.precision_recall_at_k, *cfg.mrr_at_k,
             *cfg.ndcg_at_k, *cfg.map_at_k))
        self._sink = (
            CsvSink(os.path.join(log_dir, name + "_results.csv"),
                    ["epoch", "steps", "score_fn", "metric", "value"])
            if log_dir else None
        )

    def __call__(self, encode_fn: EncodeFn, epoch: int = -1,
                 steps: int = -1) -> float:
        cfg = self.cfg
        # embeddings flow encoder → index on the device
        q_emb = encode_keep_device(encode_fn, self.queries)
        if self._index is not None and self._cache_corpus_index:
            index = self._index
        else:
            c_emb = encode_keep_device(encode_fn, self.corpus_texts)
            if self._index_factory is not None:
                index = self._index_factory(c_emb, self.corpus_ids, self.mesh)
            else:
                index = ExactIndex(c_emb, ids=self.corpus_ids, mesh=self.mesh,
                                   device=self.device)
            if self._cache_corpus_index:
                self._index = index

        k = min(self.max_k, len(self.corpus_ids))
        self.last_results: Dict[str, Dict[str, float]] = {}
        rel_list = [self.relevant[q] for q in self.query_ids]
        for score_name in cfg.score_functions:
            _, ranked_ids = index.search_ids(q_emb, k=k, score=score_name)
            metrics = ir_metrics(
                ranked_ids, rel_list,
                accuracy_at_k=cfg.accuracy_at_k,
                precision_recall_at_k=cfg.precision_recall_at_k,
                mrr_at_k=cfg.mrr_at_k,
                ndcg_at_k=cfg.ndcg_at_k,
                map_at_k=cfg.map_at_k,
            )
            self.last_results[score_name] = metrics
            if self._sink is not None:
                for metric, value in metrics.items():
                    self._sink.append([epoch, steps, score_name, metric, value])

        main_k = max(cfg.map_at_k)
        return max(m[f"map@{main_k}"] for m in self.last_results.values())
