"""IR evaluation-set construction — a host copy of ``qst_tpu/evals/eval_set.py``
(``tests/test_torch_evals.py`` holds it to its source; the cache file reads
in either package).

Capability match for the reference ``create_ir_evaluation_set``
(models/evaluators.py:408-529):

- sample ``n_queries`` instances; each query is the instance's reference
  caption (optionally paraphrased by the augmentation stack's
  ``generate_variations`` — reference evaluators.py:453);
- the corpus holds every instance's positives and partially-positives, plus
  the references of non-query instances;
- relevance comes from explicit flags (use_pos / use_part_pos, reference
  :465-475) and/or from labeling (query, doc) pairs with a cross-encoder at a
  threshold (reference :501-509, SIMILARITY_THRESHOLD 0.4 :27);
- the result is cached as JSON keyed by the sampling seed and reloaded on
  rebuild (reference :416-433), and relevant-count statistics are logged
  (reference :511-519).

The reference's relevant-set bug — collapsing per-query doc lists into the
set of query keys (``set(evaluation_queries["relevant"])``, evaluators.py:561,
ir_evauation_script.py:94-95) — is fixed here: ``relevant`` maps each query id
to its own doc-id set (SURVEY.md §7 reference-bug policy).
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Set

import numpy as np

from qst_tpu_torch.core.config import (
    CROSS_ENCODER_RELEVANCE_THRESHOLD,
    KEY_PART_POSITIVE,
    KEY_POSITIVE,
    KEY_REFERENCE,
    N_IR_SAMPLES,
)

logger = logging.getLogger("qst_tpu_torch.eval_set")


@dataclass
class IREvaluationSet:
    queries: Dict[str, str]
    corpus: Dict[str, str]
    relevant: Dict[str, Set[str]]
    seed: int = 14

    def to_json(self) -> dict:
        return {
            "seed": self.seed,
            "queries": self.queries,
            "corpus": self.corpus,
            "relevant": {q: sorted(docs) for q, docs in self.relevant.items()},
        }

    @classmethod
    def from_json(cls, data: dict) -> "IREvaluationSet":
        return cls(
            queries=dict(data["queries"]),
            corpus=dict(data["corpus"]),
            relevant={q: set(d) for q, d in data["relevant"].items()},
            seed=int(data.get("seed", 14)),
        )

    def stats(self) -> Dict[str, float]:
        counts = np.array([len(d) for d in self.relevant.values()])
        if counts.size == 0:
            return {"mean": 0.0, "p25": 0.0, "p50": 0.0, "p75": 0.0}
        return {
            "mean": float(counts.mean()),
            "p25": float(np.quantile(counts, 0.25)),
            "p50": float(np.quantile(counts, 0.5)),
            "p75": float(np.quantile(counts, 0.75)),
        }


def create_ir_evaluation_set(
    instances: Sequence[dict],
    n_queries: int = N_IR_SAMPLES,
    use_pos_examples: bool = True,
    use_part_pos_examples: bool = True,
    cross_encoder_predict: Optional[Callable] = None,
    cross_encoder_threshold: float = CROSS_ENCODER_RELEVANCE_THRESHOLD,
    query_variation_fn: Optional[Callable[[str], str]] = None,
    seed: int = 14,
    cache_path: Optional[str] = None,
) -> IREvaluationSet:
    # cache hit → reload (reference evaluators.py:416-433 keyed on seed)
    if cache_path and os.path.isfile(cache_path):
        with open(cache_path) as f:
            data = json.load(f)
        if int(data.get("seed", -1)) == seed:
            logger.info("loaded cached IR evaluation set from %s", cache_path)
            return IREvaluationSet.from_json(data)

    rng = np.random.default_rng(seed)
    n_inst = len(instances)
    if n_inst == 0:
        raise ValueError("no instances to build an evaluation set from")
    n_queries = min(n_queries, n_inst)
    query_positions = set(
        int(i) for i in rng.choice(n_inst, size=n_queries, replace=False))

    queries: Dict[str, str] = {}
    corpus: Dict[str, str] = {}
    relevant: Dict[str, Set[str]] = {}

    for i, inst in enumerate(instances):
        iid = str(inst.get("id", i))
        if i in query_positions:
            text = inst[KEY_REFERENCE]
            if query_variation_fn is not None:
                text = query_variation_fn(text)
            queries[f"q{iid}"] = text
            relevant[f"q{iid}"] = set()
        else:
            # non-query references join the corpus (reference :465-475)
            corpus[f"ref{iid}"] = inst[KEY_REFERENCE]
        for j, pos in enumerate(inst.get(KEY_POSITIVE, [])):
            corpus[f"pos{iid}_{j}"] = pos
        for j, part in enumerate(inst.get(KEY_PART_POSITIVE, [])):
            corpus[f"part{iid}_{j}"] = part

    for i, inst in enumerate(instances):
        if i not in query_positions:
            continue
        iid = str(inst.get("id", i))
        qid = f"q{iid}"
        if use_pos_examples:
            relevant[qid] |= {
                f"pos{iid}_{j}" for j in range(len(inst.get(KEY_POSITIVE, [])))}
        if use_part_pos_examples:
            relevant[qid] |= {
                f"part{iid}_{j}"
                for j in range(len(inst.get(KEY_PART_POSITIVE, [])))}

    if cross_encoder_predict is not None:
        # Score ALL (query, doc) pairs in one call so the device scorer sees
        # a single flat Q*N pair list and batches it into fixed shapes —
        # not one host->device round trip per query (the reference's
        # per-query loop, evaluators.py:501-509, is the anti-pattern the
        # batched design exists to kill).
        corpus_ids = list(corpus.keys())
        corpus_texts = [corpus[c] for c in corpus_ids]
        query_ids = list(queries.keys())
        pairs = [(queries[qid], doc)
                 for qid in query_ids for doc in corpus_texts]
        scores = np.asarray(cross_encoder_predict(pairs)).reshape(
            len(query_ids), len(corpus_ids))
        for qi, qid in enumerate(query_ids):
            hits = np.nonzero(scores[qi] >= cross_encoder_threshold)[0]
            relevant[qid] |= {corpus_ids[int(h)] for h in hits}

    out = IREvaluationSet(queries=queries, corpus=corpus, relevant=relevant,
                          seed=seed)
    stats = out.stats()
    logger.info("IR eval set: %d queries, %d docs, relevant-count stats %s",
                len(queries), len(corpus), stats)
    if cache_path:
        os.makedirs(os.path.dirname(os.path.abspath(cache_path)), exist_ok=True)
        with open(cache_path, "w") as f:
            json.dump(out.to_json(), f)
    return out
