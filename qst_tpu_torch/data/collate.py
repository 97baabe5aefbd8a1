"""Fixed-shape quadruplet batch collation — a host copy of
``qst_tpu/data/collate.py`` (``tests/test_torch_data.py`` holds it to its
source).

Replaces the reference's dynamic ``smart_batching_collate`` +
``to_input_example`` adapters (reference quadruplet_sentence_transformer.py:83-133)
with a collator that tokenizes the four roles and STACKS them into one
(4, B, S) tensor pair — the train step then runs a single (4·B, S) encoder
forward instead of the reference's four sequential forwards
(quadruplet_sentence_transformer.py:42-60), which quadruples the effective
matmul batch.

``select_single_example`` mirrors the reference adapter of the same name
(quadruplet_sentence_transformer.py:105-133) with its two defects fixed
(off-by-one randint at :124,126 and the part-pos gate testing the wrong key
at :127-128) — SURVEY.md §7's reference-bug policy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from qst_tpu_torch.core.config import (
    QUADRUPLET_KEYS,
)


@dataclass
class QuadrupletBatch:
    """Stacked token batch: arrays of shape (4, B, S) ordered
    (reference, positive, part_positive, negative)."""

    input_ids: np.ndarray
    attention_mask: np.ndarray

    @property
    def batch_size(self) -> int:
        return self.input_ids.shape[1]

    def flat(self) -> tuple[np.ndarray, np.ndarray]:
        """→ ((4·B, S), (4·B, S)) for the single fused forward."""
        four, B, S = self.input_ids.shape
        return (self.input_ids.reshape(four * B, S),
                self.attention_mask.reshape(four * B, S))


def select_single_example(instance: Dict[str, Any],
                          rng: Optional[np.random.Generator] = None
                          ) -> Dict[str, str]:
    """Reduce a multi-example instance to one text per role."""
    rng = rng or np.random.default_rng()

    def pick(value):
        if isinstance(value, str):
            return value
        if not value:
            raise ValueError("empty example list")
        return value[int(rng.integers(0, len(value)))]

    return {k: pick(instance[k]) for k in QUADRUPLET_KEYS}


class QuadrupletCollator:
    def __init__(self, tokenizer: Any, max_length: int = 128,
                 seed: int = 14):
        self.tokenizer = tokenizer
        self.max_length = max_length
        self._rng = np.random.default_rng(seed)

    def __call__(self, instances: Sequence[Dict[str, Any]]) -> QuadrupletBatch:
        B = len(instances)
        singles = [select_single_example(inst, self._rng) for inst in instances]
        texts: List[str] = []
        for key in QUADRUPLET_KEYS:
            texts.extend(s[key] for s in singles)
        ids, mask = self.tokenizer.batch_encode(texts, max_length=self.max_length)
        S = ids.shape[1]
        return QuadrupletBatch(
            input_ids=ids.reshape(4, B, S),
            attention_mask=mask.reshape(4, B, S),
        )
