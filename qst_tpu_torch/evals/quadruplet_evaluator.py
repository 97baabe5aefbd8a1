"""Quadruplet ordering-accuracy evaluator — counterpart of
``qst_tpu/evals/quadruplet_evaluator.py``.

Capability match for the reference ``QuadrupletEvaluator``
(models/evaluators.py:130-387): decomposes quadruplet ordering into three
triplet accuracies —

- pos vs part   (is the positive closer to the anchor than the partial?)
- pos vs neg
- part vs neg

— and combines them with the reference's global-accuracy formula
(evaluators.py:367): ``((1−γ)·pos_part + γ·part_neg + pos_neg) / 2``.

Examples are resampled from the full dataset every
``N_EVALS_RESET_EXAMPLES`` calls (reference ``N_EPOCHS_RESET_EXAMPLES=5``,
``_reset_examples`` :266-345). The similarities come from ONE batched encode
of the 4·N texts and are computed where the encoder left the embeddings (on
the GPU for ``SentenceEncoder.encode``); only the three (N,) similarity
vectors reach the host. CSV results are appended per call.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from qst_tpu_torch.core.config import (
    DEFAULT_GAMMA,
    KEY_NEGATIVE,
    KEY_PART_POSITIVE,
    KEY_POSITIVE,
    KEY_REFERENCE,
)
from qst_tpu_torch.core.telemetry import CsvSink
from qst_tpu_torch.evals.ir_metrics import quadruplet_global_accuracy, triplet_accuracy
from qst_tpu_torch.retrieval.retriever import encode_keep_device

N_EVALS_RESET_EXAMPLES = 5

EncodeFn = Callable[[Sequence[str]], np.ndarray]


class QuadrupletEvaluator:
    def __init__(
        self,
        anchors: List[str],
        positives: List[str],
        part_positives: List[str],
        negatives: List[str],
        gamma: float = DEFAULT_GAMMA,
        log_dir: Optional[str] = None,
        name: str = "quadruplet",
        resampler: Optional[Callable[[], tuple]] = None,
        reset_every: int = N_EVALS_RESET_EXAMPLES,
    ):
        n = len(anchors)
        if not (len(positives) == len(part_positives) == len(negatives) == n):
            raise ValueError("quadruplet example lists must share a length")
        if n == 0:
            raise ValueError("need at least one quadruplet example")
        self.anchors = list(anchors)
        self.positives = list(positives)
        self.part_positives = list(part_positives)
        self.negatives = list(negatives)
        self.gamma = gamma
        self.resampler = resampler
        self.reset_every = reset_every
        self._calls = 0
        self._sink = (
            CsvSink(
                os.path.join(log_dir, name + "_results.csv"),
                ["epoch", "steps", "acc_pos_part", "acc_pos_neg",
                 "acc_part_neg", "global_accuracy"],
            )
            if log_dir else None
        )

    @classmethod
    def from_instances(cls, instances: Sequence[dict],
                       rng: Optional[np.random.Generator] = None, **kw):
        """Build from sampled quadruplet instances (one example per role,
        mirroring reference ``from_input_examples`` evaluators.py:225-264)."""
        rng = rng or np.random.default_rng(14)

        def one(v):
            return v if isinstance(v, str) else v[int(rng.integers(0, len(v)))]

        return cls(
            anchors=[one(i[KEY_REFERENCE]) for i in instances],
            positives=[one(i[KEY_POSITIVE]) for i in instances],
            part_positives=[one(i[KEY_PART_POSITIVE]) for i in instances],
            negatives=[one(i[KEY_NEGATIVE]) for i in instances],
            **kw,
        )

    def _maybe_reset(self) -> None:
        if self.resampler is not None and self._calls > 0 \
                and self._calls % self.reset_every == 0:
            a, p, t, n = self.resampler()
            self.anchors, self.positives = list(a), list(p)
            self.part_positives, self.negatives = list(t), list(n)

    def __call__(self, encode_fn: EncodeFn, epoch: int = -1,
                 steps: int = -1) -> float:
        self._maybe_reset()
        self._calls += 1
        n = len(self.anchors)
        all_texts = (self.anchors + self.positives + self.part_positives
                     + self.negatives)
        emb = torch.as_tensor(encode_keep_device(encode_fn, all_texts)).float()
        emb = emb / torch.clamp(torch.linalg.vector_norm(emb, dim=1, keepdim=True), min=1e-12)
        a, p, t, g = emb[:n], emb[n:2 * n], emb[2 * n:3 * n], emb[3 * n:]
        sims = torch.stack([torch.sum(a * p, dim=1), torch.sum(a * t, dim=1),
                            torch.sum(a * g, dim=1)]).cpu().numpy()
        sim_ap, sim_at, sim_an = sims
        acc_pos_part = triplet_accuracy(sim_ap, sim_at)
        acc_pos_neg = triplet_accuracy(sim_ap, sim_an)
        acc_part_neg = triplet_accuracy(sim_at, sim_an)
        global_acc = quadruplet_global_accuracy(
            acc_pos_part, acc_part_neg, acc_pos_neg, self.gamma)
        if self._sink is not None:
            self._sink.append([epoch, steps, acc_pos_part, acc_pos_neg,
                               acc_part_neg, global_acc])
        self.last_scores = {
            "acc_pos_part": acc_pos_part,
            "acc_pos_neg": acc_pos_neg,
            "acc_part_neg": acc_part_neg,
            "global_accuracy": global_acc,
        }
        return global_acc
