"""Positive-example mining from caption groups — a host copy of
``qst_tpu/augment/positive_mining.py`` (``tests/test_torch_augment.py``
holds it to its source).

Capability match for reference ``dataset/positive_examples_selection.py``:

- ``pop_random_caption``: O(1) swap-remove random draw with a forbidden set
  and bounded iterations (reference :59-89);
- ``select_positive_examples``: choose a reference caption, keep captions
  with cos ≥ threshold (0.6), retry with a fresh reference up to
  ``max_attempts``, fall back to the top-k most similar (TOP_K_BACKUP=2,
  reference :11,:144-147), then top up to ``n_examples`` by augmentation
  (backtranslation (+ optional MLM insert) + synonym replacement,
  reference :154-193) with the same sample-then-repeat fill logic.

The embedder is an injected ``encode_fn`` (batched on device) instead of the
reference's process-global ``@synchronized`` SBERT singleton (:32-43);
``compute_cosine_scores`` keeps the one-anchor-vs-pool scoring surface used
by both mining paths.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Set, Tuple, Union

import numpy as np

from qst_tpu_torch.core.config import (
    MAX_WORDS_TO_REPLACE,
    N_EXAMPLES,
    NO_REPLACE_WORDS,
    POSITIVE_SIM_THRESHOLD,
)
from qst_tpu_torch.augment.backtranslation import perform_back_translation
from qst_tpu_torch.augment.synonyms import SynonymAugmenter

TOP_K_BACKUP = 2
MAX_ATTEMPTS = 3

EncodeFn = Callable[[Sequence[str]], np.ndarray]


def compute_cosine_scores(caption: str, captions: Sequence[str],
                          encode_fn: EncodeFn) -> np.ndarray:
    emb = np.asarray(encode_fn([caption] + list(captions)), np.float32)
    emb = emb / np.clip(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12, None)
    return emb[1:] @ emb[0]


def pop_random_caption(captions: List[str],
                       forbidden: Set[str] = frozenset(),
                       max_iterations: int = 50,
                       rng: Optional[np.random.Generator] = None) -> str:
    """Draw and remove a random non-forbidden caption (O(1) swap-remove);
    after ``max_iterations`` failed draws, return a (possibly forbidden)
    duplicate without removal (reference :59-89)."""
    if max_iterations == 0:
        raise ValueError(
            f"max_iterations must be > 0 or < 0, {max_iterations} given.")
    if not captions:
        raise ValueError("empty caption list")
    rng = rng or np.random.default_rng()
    iters = 0
    while iters < max_iterations or max_iterations < 0:
        i = int(rng.integers(0, len(captions)))
        if captions[i] not in forbidden:
            captions[i], captions[-1] = captions[-1], captions[i]
            return captions.pop()
        if max_iterations > 0:
            iters += 1
    return captions[int(rng.integers(0, len(captions)))]


def select_positive_examples(
    captions: List[str],
    encode_fn: EncodeFn,
    threshold: float = POSITIVE_SIM_THRESHOLD,
    n_examples: int = N_EXAMPLES,
    augment: bool = True,
    mlm_insert: Optional[Callable[[List[str]], List[str]]] = None,
    return_similarities: bool = False,
    max_attempts: int = MAX_ATTEMPTS,
    rng: Optional[np.random.Generator] = None,
) -> Union[List[str], Tuple[List[str], str, np.ndarray]]:
    """→ positive examples for a randomly chosen reference caption (the list
    is mutated: the reference is removed, as in the reference impl)."""
    if not 0 < max_attempts <= len(captions):
        raise ValueError(
            f"max_attempts must be between 1 and the number of captions "
            f"{len(captions)}. {max_attempts} given.")
    rng = rng or np.random.default_rng()

    already_attempted: Set[str] = set()
    caption = pop_random_caption(captions, already_attempted, rng=rng)
    already_attempted.add(caption)

    selected: List[str] = []
    cos_scores = np.zeros((0,), np.float32)
    attempts = 0
    while not selected and attempts < max_attempts:
        cos_scores = compute_cosine_scores(caption, captions, encode_fn)
        selected = [c for c, s in zip(captions, cos_scores) if s >= threshold]
        if not selected:
            attempts += 1
            if attempts >= max_attempts:
                break
            new_caption = pop_random_caption(captions, already_attempted,
                                             rng=rng)
            captions.append(caption)  # previous reference rejoins the pool
            already_attempted.add(new_caption)
            caption = new_caption

    if not selected and len(cos_scores):
        # fall back to the top-k most similar (reference :144-147)
        k = min(TOP_K_BACKUP, len(cos_scores))
        for idx in np.argsort(-cos_scores)[:k]:
            selected.append(captions[int(idx)])

    n_lacking = n_examples - len(selected)
    if n_lacking > 0 and selected:
        if augment:
            new_captions = perform_back_translation(selected)
            if mlm_insert is not None:
                new_captions = mlm_insert(new_captions)
            syn = SynonymAugmenter(
                aug_min=1, aug_max=MAX_WORDS_TO_REPLACE,
                stopwords=tuple(NO_REPLACE_WORDS),
                seed=int(rng.integers(0, 2**31 - 1)))
            new_captions = syn.augment(new_captions)
        else:
            new_captions = list(selected)

        take = min(n_lacking, len(new_captions))
        picked_idx = rng.choice(len(new_captions), size=take, replace=False)
        picked = [new_captions[int(i)] for i in picked_idx]
        if len(picked) < n_lacking:  # repeat-fill (reference :187-192)
            n_repeats = math.ceil(n_lacking / len(picked)) - 1
            picked = (picked + picked * n_repeats)[:n_lacking]
        selected.extend(picked)

    if return_similarities:
        return selected, caption, cos_scores
    return selected
