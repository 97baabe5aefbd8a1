"""Sentence-compression dataset construction — a host copy of
``qst_tpu/data/sentence_compression.py`` (``tests/test_torch_dataset.py``
holds it to its source and to the chunk files the JAX package writes).

Capability match for reference ``dataset/sentence_compr_dataset_creation.py``:
each record holds a full sentence and a compression with a compression
ratio; ratio ≥ 0.6 classifies the compression as a POSITIVE, ratio < 0.6 as
a PARTIALLY-POSITIVE (``COMPRESSION_RATIO_THRESHOLD`` reference :23,
:65-110). ``generate_variations`` is the shared paraphraser (MLM insert /
substitute + synonym replace + backtranslation, reference :30-62) also used
for IR query paraphrasing (reference evaluators.py:453). Chunk writing is
resumable like the COCO path (reference :178-200).

Records are plain dicts ``{"sentence": ..., "compression": ...,
"compression_ratio": ...}`` — loadable from the HF ``sent_comp`` dataset or
any JSONL; no network dependency.

Note: the reference generates the part-pos "variations" from the FULL
sentence (:94-98), which would produce positives; the intent is clearly
variations of the *compression* (a partial match), and that is what this
implementation does.
"""

from __future__ import annotations

import logging
import math
import os
import traceback
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from qst_tpu_torch.core.config import (
    CHUNK_DIM,
    KEY_PART_POSITIVE,
    KEY_POSITIVE,
    KEY_REFERENCE,
    N_EXAMPLES,
    N_PART_EXAMPLES,
)
from qst_tpu_torch.augment.backtranslation import perform_back_translation
from qst_tpu_torch.augment.partial_positive import (
    ADAPTIVE_CROP_AUGMENT,
    get_part_pos_examples,
)
from qst_tpu_torch.augment.synonyms import SynonymAugmenter
from qst_tpu_torch.data.chunks import write_chunk, write_meta

logger = logging.getLogger("qst_tpu_torch.sent_comp")

COMPRESSION_RATIO_THRESHOLD = 0.6

# variation-pipeline stage names (reference :24-28)
REPLACE_WORDNET = "replace_wordnet"
REPLACE_BERT = "replace_bert"
INSERT_BERT = "insert_bert"
BACKTRANSL = "backtranslation"
DEFAULT_AUGS = frozenset([REPLACE_WORDNET, BACKTRANSL, INSERT_BERT])


def generate_variations(
    sentence,
    n: int,
    augs: Iterable[str] = DEFAULT_AUGS,
    mlm_insert: Optional[Callable[[List[str]], List[str]]] = None,
    mlm_substitute: Optional[Callable[[List[str]], List[str]]] = None,
    seed: int = 14,
) -> List[str]:
    """n paraphrases of ``sentence`` via the configured augmentation stages.
    MLM stages are injected callables, skipped when absent, as in the source
    (``augment.MLMAugmenter``'s ``insert`` / ``substitute`` fit them);
    backtranslation goes through ``get_backtranslator``'s memoized backend,
    the on-card Marian when its checkpoints are set."""
    if n <= 0:
        return []
    sentences = list(np.repeat(sentence, n))
    augs = set(augs)
    if INSERT_BERT in augs and mlm_insert is not None:
        sentences = mlm_insert(sentences)
    if REPLACE_BERT in augs and mlm_substitute is not None:
        sentences = mlm_substitute(sentences)
    if REPLACE_WORDNET in augs:
        sentences = SynonymAugmenter(aug_min=1, aug_max=4,
                                     seed=seed).augment(sentences)
    if BACKTRANSL in augs:
        sentences = perform_back_translation(sentences)
    return sentences


def get_pos_examples_sentence_compr(record: Dict, n: int,
                                    seed: int = 14) -> Tuple[List[str], str]:
    """→ (positives, reference sentence); the compression joins the positives
    when its ratio ≥ threshold (reference :65-81)."""
    reference_text = record["sentence"]
    compression = record["compression"]
    ratio = float(record["compression_ratio"])
    pos = [reference_text]
    if ratio >= COMPRESSION_RATIO_THRESHOLD:
        pos.append(compression)
    remaining = n - 1 if len(pos) == 2 else n
    pos.extend(generate_variations(reference_text, n=remaining, seed=seed))
    return pos, reference_text


def get_part_pos_examples_sentence_compr(record: Dict, n: int,
                                         seed: int = 14) -> List[str]:
    """→ partial positives: a low-ratio compression plus its variations, the
    rest from adaptive crop of the full sentence (reference :84-110)."""
    reference_text = record["sentence"]
    compression = record["compression"]
    ratio = float(record["compression_ratio"])

    part: List[str] = []
    remaining = n
    if ratio < COMPRESSION_RATIO_THRESHOLD:
        part.append(compression)
        part.extend(generate_variations(
            compression, n=math.ceil(n / 2),
            augs=[REPLACE_WORDNET, BACKTRANSL], seed=seed))
        remaining = math.floor(n / 2) - 1
    if remaining > 0:
        part.extend(get_part_pos_examples(
            caption=reference_text,
            n_part_pos_examples=remaining,
            algorithm_type=ADAPTIVE_CROP_AUGMENT,
            rng=np.random.default_rng(seed),
        ))
    return part


def create_sentence_compression_chunk(
    records: Sequence[Dict],
    start_idx: int = 0,
    chunk_dim: int = CHUNK_DIM,
    n_pos_examples: int = N_EXAMPLES,
    n_part_pos_examples: int = N_PART_EXAMPLES,
    seed: int = 14,
) -> List[dict]:
    end_idx = min(start_idx + chunk_dim, len(records))
    instances = []
    for idx in range(start_idx, end_idx):
        rec = records[idx]
        pos, reference = get_pos_examples_sentence_compr(
            rec, n_pos_examples, seed=seed + idx)
        part = get_part_pos_examples_sentence_compr(
            rec, n_part_pos_examples, seed=seed + idx)
        instances.append({
            "id": idx,
            KEY_REFERENCE: reference,
            KEY_POSITIVE: pos,
            KEY_PART_POSITIVE: part,
        })
    return instances


def create_dataset_sentence_compression(
    root: str,
    records: Sequence[Dict],
    dataset_name: str = "sent_compr",
    start_chunk: int = 0,
    last_chunk: Optional[int] = None,
    chunk_dim: int = CHUNK_DIM,
    n_pos_examples: int = N_EXAMPLES,
    n_part_pos_examples: int = N_PART_EXAMPLES,
    seed: int = 14,
) -> int:
    """Chunk-resumable writer; → last successfully written chunk index."""
    out_root = os.path.join(root, dataset_name)
    os.makedirs(out_root, exist_ok=True)
    n_chunks_total = -(-len(records) // chunk_dim)
    end = n_chunks_total if last_chunk is None else min(n_chunks_total,
                                                        last_chunk + 1)
    last_ok = start_chunk - 1
    for chunk_idx in range(start_chunk, end):
        try:
            instances = create_sentence_compression_chunk(
                records, start_idx=chunk_idx * chunk_dim, chunk_dim=chunk_dim,
                n_pos_examples=n_pos_examples,
                n_part_pos_examples=n_part_pos_examples,
                seed=seed + chunk_idx * chunk_dim)
            write_chunk(out_root, chunk_idx, instances,
                        dataset_name=dataset_name)
            last_ok = chunk_idx
        except Exception as e:
            logger.error("Chunk %d creation failed: %s\n%s", chunk_idx, e,
                         traceback.format_exc())
            return last_ok
    write_meta(out_root, last_ok + 1)
    return last_ok
