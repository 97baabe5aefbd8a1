"""Partially-positive example synthesis — a host copy of
``qst_tpu/augment/partial_positive.py`` (``tests/test_torch_augment.py``
holds it to its source).

Capability match for reference
``dataset/partially_positive_examples_selection.py`` — four strategies keyed
by algorithm type (reference :216-238):

- ``adaptive_crop``: POS-tag the caption (universal tagset), cut a random
  56–80% of the words from prefix or suffix ending at a NOUN/VERB boundary
  (the reference's ``random.randint(3/4·max, max)`` with ``max = 4/5·n``,
  :49-59), fix punctuation spacing (:116), then synonym-augment;
- ``adaptive_crop_augment``: adds backtranslation (:231-235);
- ``llm`` (chatgpt/falcon/alpaca in the reference): prompt an LLM for 5
  numbered partial sentences (:195-212) and parse them by splitting on
  ``[0-9].`` (:29-40); the LLM callable is pluggable, with the reference's
  canned mock response as the fallback (:23-26);
- a fixed-mock fallback for anything unknown (:237-238).

Two reference defects fixed per SURVEY.md §7 bug policy: the prefix-branch
tag test ``tag=='NOUN' or tag=='VERB' or 'DET'`` is always-true (:97) — here
the boundary genuinely checks NOUN/VERB/DET; and the suffix/prefix halves of
``adaptive_crop_part_pos_examples`` both passed ``crop_prefix=True``
(:154-168) — here the suffix half actually crops the suffix.
"""

from __future__ import annotations

import math
import re
from typing import Callable, List, Optional

import numpy as np

from qst_tpu_torch.core.config import N_PART_EXAMPLES
from qst_tpu_torch.augment.backtranslation import perform_back_translation
from qst_tpu_torch.augment.pos_tagger import pos_tag_universal
from qst_tpu_torch.augment.synonyms import SynonymAugmenter

# strategy names
ADAPTIVE_CROP = "adaptive_crop"
ADAPTIVE_CROP_AUGMENT = "adaptive_crop_augment"
LLM = "llm"
MOCK = "mock"

MIN_RESPONSE_NUM = 5

MOCK_LLM_RESPONSE = (
    "1. Woman wearing a hat;  2. Woman taking a photo;  3. Woman riding "
    "a bike;  4. Parking lot surrounded by trees;  5. Woman standing in "
    "the parking lot."
)


def mock_llm_response(caption: str,
                      n_responses: int = MIN_RESPONSE_NUM) -> str:
    """Canned response (reference :23-26) — the hermetic-test fallback."""
    return MOCK_LLM_RESPONSE


def build_llm_prompt(caption: str,
                     n_part_pos_examples: int = N_PART_EXAMPLES) -> str:
    """The reference's extraction prompt (reference :197-204)."""
    return (
        f"Given the sentence '{caption}' describing a scene, "
        "identity the main objects/elements and provide 5 very "
        "short numbered sentences that contain just some "
        "elements, objects or subjects from sentence and not "
        "all of them. Do not add any new element, object "
        "or subject, only use the nouns identified in the given sentence. "
        "Format the output giving the identified objects and "
        "the numbered sentences."
    )


def parse_llm_response(llm_response: str,
                       min_response_num: int = MIN_RESPONSE_NUM) -> List[str]:
    """Split a numbered-list response on ``[0-9].`` markers and normalize
    (reference :29-40)."""
    responses = re.split(r"[0-9]\.", llm_response)[1:]
    if len(responses) < min_response_num:
        raise ValueError(
            f"LLM response had {len(responses)} numbered items, "
            f"expected >= {min_response_num}")
    return [r.strip().lower().replace(";", "").replace(".", "")
            for r in responses]


def _fix_punct_spacing(text: str) -> str:
    return re.sub(r'\s([?.!",](?:\s|$))', r"\1", text)


def crop_text_based_on_tagging(
    text: str,
    crop_prefix: bool = False,
    max_words_to_cut: Optional[int] = None,
    synonym_aug: Optional[SynonymAugmenter] = None,
    backtranslate: bool = False,
    repeat: int = 1,
    rng: Optional[np.random.Generator] = None,
) -> List[str]:
    """Crop a random span from one end, snapping the kept side to a
    NOUN/VERB (suffix crop) or NOUN/VERB/DET (prefix crop) boundary."""
    rng = rng or np.random.default_rng()
    n_words = len(text.split(" "))
    cap = int(4 / 5 * n_words)
    max_cut = cap if max_words_to_cut is None else min(max_words_to_cut, cap)

    out: List[str] = []
    for _ in range(repeat):
        lo = int(3 / 4 * max_cut)
        n_cut = int(rng.integers(lo, max_cut + 1)) if max_cut > 0 else 0
        tags = pos_tag_universal(text)
        new_text = text

        if not crop_prefix:
            # keep a prefix: last kept word must be NOUN or VERB
            count, last_idx = 0, None
            for i, (word, tag) in enumerate(reversed(tags)):
                if tag in ("NOUN", "VERB"):
                    last_idx = len(tags) - 1 - i
                if tag != ".":
                    count += 1
                if count >= n_cut:
                    break
            if last_idx is not None:
                new_text = " ".join(w for w, _ in tags[: last_idx + 1])
        else:
            # keep a suffix: first kept word must be NOUN, VERB, or DET
            count, first_idx = 0, None
            for i, (word, tag) in enumerate(tags):
                if tag in ("NOUN", "VERB", "DET"):
                    first_idx = i
                if tag != ".":
                    count += 1
                if count >= n_cut:
                    break
            if first_idx is not None:
                new_text = " ".join(w for w, _ in tags[first_idx:])

        new_text = _fix_punct_spacing(new_text)
        if backtranslate:
            new_text = perform_back_translation([new_text])[0]
        if synonym_aug is not None:
            new_text = synonym_aug.augment_one(new_text)
        out.append(new_text)
    return out


def adaptive_crop_part_pos_examples(
    caption: str,
    n_part_pos_examples: int,
    augment_backtranslation: bool = False,
    mlm_insert: Optional[Callable[[List[str]], List[str]]] = None,
    rng: Optional[np.random.Generator] = None,
    seed: int = 14,
) -> List[str]:
    """Half suffix-crops + half prefix-crops, synonym-augmented, optional
    backtranslation / MLM-insert passes (reference :150-182)."""
    rng = rng or np.random.default_rng(seed)
    syn = SynonymAugmenter(seed=int(rng.integers(0, 2**31 - 1)))
    suffix = crop_text_based_on_tagging(
        caption, crop_prefix=False, synonym_aug=syn,
        repeat=math.ceil(n_part_pos_examples / 2), rng=rng)
    prefix = crop_text_based_on_tagging(
        caption, crop_prefix=True, synonym_aug=syn,
        repeat=math.floor(n_part_pos_examples / 2), rng=rng)
    examples = suffix + prefix
    if augment_backtranslation:
        examples = perform_back_translation(examples)
    if mlm_insert is not None:
        examples = mlm_insert(examples)
    return examples


def get_part_pos_examples(
    caption: str,
    n_part_pos_examples: int = N_PART_EXAMPLES,
    algorithm_type: str = ADAPTIVE_CROP_AUGMENT,
    llm_fn: Optional[Callable[[str], str]] = None,
    rng: Optional[np.random.Generator] = None,
) -> List[str]:
    """Strategy dispatcher (reference :216-238)."""
    if algorithm_type == LLM:
        if llm_fn is None:
            # env-gated OpenAI-compatible client ($QST_LLM_BASE_URL);
            # closed gate → the canned mock (reference :237-238)
            from qst_tpu_torch.augment.llm_client import get_llm_fn

            llm_fn = get_llm_fn()
        fn = llm_fn or mock_llm_response
        return parse_llm_response(fn(build_llm_prompt(caption,
                                                      n_part_pos_examples)))
    if algorithm_type == ADAPTIVE_CROP:
        return adaptive_crop_part_pos_examples(caption, n_part_pos_examples,
                                               rng=rng)
    if algorithm_type == ADAPTIVE_CROP_AUGMENT:
        return adaptive_crop_part_pos_examples(
            caption, n_part_pos_examples, augment_backtranslation=True,
            rng=rng)
    return parse_llm_response(mock_llm_response(caption, n_part_pos_examples))
