"""IR metric suite — pure functions over ranked results; a host copy of
``qst_tpu/evals/ir_metrics.py`` (``tests/test_torch_evals.py`` holds it to
its source).

The metric definitions match sentence-transformers'
``InformationRetrievalEvaluator`` (the engine behind reference
ir_evauation_script.py:107-131): Accuracy@k, Precision@k, Recall@k, MRR@k,
NDCG@k, MAP@k, evaluated per query against a set of relevant doc ids and
averaged. Evaluator objects are replaced by pure functions over a
precomputed ranking matrix (SURVEY.md §7 design stance).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Set

import numpy as np


def _as_sets(relevant: Sequence[Set[str]]) -> List[Set[str]]:
    return [set(r) for r in relevant]


def ir_metrics(
    ranked_ids: Sequence[Sequence[str]],
    relevant: Sequence[Set[str]],
    accuracy_at_k: Sequence[int] = (1, 3, 5, 10),
    precision_recall_at_k: Sequence[int] = (1, 3, 5, 10),
    mrr_at_k: Sequence[int] = (10,),
    ndcg_at_k: Sequence[int] = (10,),
    map_at_k: Sequence[int] = (100,),
) -> Dict[str, float]:
    """Compute the full metric grid.

    ranked_ids: per query, doc ids ordered by decreasing score (length ≥ max k
    requested, shorter allowed). relevant: per query, the set of relevant ids.
    Queries with empty relevant sets are skipped (sentence-transformers
    behavior).
    """
    rel_sets = _as_sets(relevant)
    pairs = [(r, rel) for r, rel in zip(ranked_ids, rel_sets) if rel]
    n = len(pairs)
    out: Dict[str, float] = {}
    if n == 0:
        for k in accuracy_at_k:
            out[f"accuracy@{k}"] = 0.0
        for k in precision_recall_at_k:
            out[f"precision@{k}"] = 0.0
            out[f"recall@{k}"] = 0.0
        for k in mrr_at_k:
            out[f"mrr@{k}"] = 0.0
        for k in ndcg_at_k:
            out[f"ndcg@{k}"] = 0.0
        for k in map_at_k:
            out[f"map@{k}"] = 0.0
        return out

    for k in accuracy_at_k:
        out[f"accuracy@{k}"] = sum(
            1.0 for ranked, rel in pairs if any(d in rel for d in ranked[:k])
        ) / n

    for k in precision_recall_at_k:
        precisions, recalls = [], []
        for ranked, rel in pairs:
            hits = sum(1 for d in ranked[:k] if d in rel)
            precisions.append(hits / k)
            recalls.append(hits / len(rel))
        out[f"precision@{k}"] = float(np.mean(precisions))
        out[f"recall@{k}"] = float(np.mean(recalls))

    for k in mrr_at_k:
        rr = []
        for ranked, rel in pairs:
            score = 0.0
            for rank, d in enumerate(ranked[:k]):
                if d in rel:
                    score = 1.0 / (rank + 1)
                    break
            rr.append(score)
        out[f"mrr@{k}"] = float(np.mean(rr))

    for k in ndcg_at_k:
        ndcgs = []
        for ranked, rel in pairs:
            dcg = sum(
                1.0 / math.log2(rank + 2)
                for rank, d in enumerate(ranked[:k]) if d in rel
            )
            ideal = sum(1.0 / math.log2(rank + 2)
                        for rank in range(min(k, len(rel))))
            ndcgs.append(dcg / ideal if ideal > 0 else 0.0)
        out[f"ndcg@{k}"] = float(np.mean(ndcgs))

    for k in map_at_k:
        aps = []
        for ranked, rel in pairs:
            hits, precision_sum = 0, 0.0
            for rank, d in enumerate(ranked[:k]):
                if d in rel:
                    hits += 1
                    precision_sum += hits / (rank + 1)
            denom = min(k, len(rel))
            aps.append(precision_sum / denom if denom else 0.0)
        out[f"map@{k}"] = float(np.mean(aps))

    return out


def triplet_accuracy(sim_pos: np.ndarray, sim_other: np.ndarray) -> float:
    """Fraction of rows where the positive outranks the other
    (sentence-transformers TripletEvaluator semantics, similarity form)."""
    return float(np.mean(sim_pos > sim_other))


def quadruplet_global_accuracy(acc_pos_part: float, acc_part_neg: float,
                               acc_pos_neg: float, gamma: float) -> float:
    """Reference global-accuracy formula (models/evaluators.py:367):
    ((1−γ)·pos_part + γ·part_neg + pos_neg) / 2."""
    return ((1.0 - gamma) * acc_pos_part + gamma * acc_part_neg + acc_pos_neg) / 2.0
