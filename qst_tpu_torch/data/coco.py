"""COCO-captions dataset construction — a host copy of ``qst_tpu/data/coco.py``
(``tests/test_torch_dataset.py`` holds it to its source and to the chunk
files the JAX package writes).

Capability match for reference ``dataset/coco_dataset_creation.py``:

- ``CocoCaptionsSource``: caption groups per image from a COCO annotation
  JSON. The reference subclasses torchvision ``CocoCaptions`` with a blank
  ``_load_image`` because only captions matter (:38-41); here the annotation
  file is parsed directly (captions need no mask/RLE code, SURVEY.md §2.3) —
  no pycocotools, no image tree on disk;
- ``create_coco_dataset_chunk``: per image, mine positives (cos ≥ threshold
  with retries) and synthesize partial positives, emit the reference's chunk
  schema (:44-89);
- ``create_coco_dataset``: chunk loop with per-chunk try/except returning the
  last good chunk index — resumable construction (:92-138) — writing
  ``chunk_<i>.json`` + the chunk-count metadata.
"""

from __future__ import annotations

import json
import logging
import os
import traceback
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from qst_tpu_torch.core.config import (
    CHUNK_DIM,
    KEY_PART_POSITIVE,
    KEY_POSITIVE,
    KEY_REFERENCE,
    N_EXAMPLES,
    N_PART_EXAMPLES,
    POSITIVE_SIM_THRESHOLD,
)
from qst_tpu_torch.augment.partial_positive import (
    ADAPTIVE_CROP,
    get_part_pos_examples,
)
from qst_tpu_torch.augment.positive_mining import select_positive_examples
from qst_tpu_torch.data.chunks import write_chunk, write_meta

logger = logging.getLogger("qst_tpu_torch.coco")


class CocoCaptionsSource:
    """Caption groups from a COCO captions annotation JSON
    (``{"images": [{"id", ...}], "annotations": [{"image_id", "caption"}]}``).
    Index order follows the images list, like torchvision's CocoCaptions."""

    def __init__(self, ann_file: str, dataset_name: str = "CoCoCaptionDataset"):
        self.ann_file = ann_file
        self.dataset_name = dataset_name
        with open(ann_file) as f:
            data = json.load(f)
        caps: Dict[int, List[str]] = {}
        for ann in data.get("annotations", []):
            caps.setdefault(int(ann["image_id"]), []).append(ann["caption"])
        if "images" in data and data["images"]:
            self.image_ids = [int(im["id"]) for im in data["images"]
                              if int(im["id"]) in caps]
        else:
            self.image_ids = sorted(caps)
        self._captions = caps

    def __len__(self) -> int:
        return len(self.image_ids)

    def __getitem__(self, idx: int) -> List[str]:
        return list(self._captions[self.image_ids[idx]])


def create_coco_dataset_chunk(
    dataset: CocoCaptionsSource,
    encode_fn: Callable[[Sequence[str]], np.ndarray],
    start_idx: int = 0,
    chunk_dim: int = CHUNK_DIM,
    n_pos_examples: int = N_EXAMPLES,
    n_part_pos_examples: int = N_PART_EXAMPLES,
    sim_threshold: float = POSITIVE_SIM_THRESHOLD,
    augment: bool = True,
    part_pos_algorithm: str = ADAPTIVE_CROP,
    rng: Optional[np.random.Generator] = None,
) -> List[dict]:
    rng = rng or np.random.default_rng(start_idx)
    end_idx = min(start_idx + chunk_dim, len(dataset))
    instances: List[dict] = []
    for idx in range(start_idx, end_idx):
        captions = dataset[idx]
        positives, reference, _ = select_positive_examples(
            captions=captions,
            encode_fn=encode_fn,
            threshold=sim_threshold,
            n_examples=n_pos_examples,
            augment=augment,
            return_similarities=True,
            max_attempts=max(1, min(n_pos_examples, len(captions))),
            rng=rng,
        )
        part_pos = get_part_pos_examples(
            caption=reference,
            n_part_pos_examples=n_part_pos_examples,
            algorithm_type=part_pos_algorithm,
            rng=rng,
        )
        instances.append({
            "id": idx,
            KEY_REFERENCE: reference,
            KEY_POSITIVE: positives,
            KEY_PART_POSITIVE: part_pos,
        })
    return instances


def create_coco_dataset(
    root: str,
    dataset: CocoCaptionsSource,
    encode_fn: Callable[[Sequence[str]], np.ndarray],
    start_chunk: int = 0,
    last_chunk: Optional[int] = None,
    chunk_dim: int = CHUNK_DIM,
    n_pos_examples: int = N_EXAMPLES,
    n_part_pos_examples: int = N_PART_EXAMPLES,
    sim_threshold: float = POSITIVE_SIM_THRESHOLD,
    augment: bool = True,
    part_pos_algorithm: str = ADAPTIVE_CROP,
    seed: int = 14,
) -> int:
    """→ index of the last successfully written chunk (−1 if none); a chunk
    failure logs the traceback and stops, so a rerun with
    ``start_chunk=returned+1`` resumes (reference :92-138)."""
    out_root = os.path.join(root, dataset.dataset_name)
    os.makedirs(out_root, exist_ok=True)
    n_chunks_total = -(-len(dataset) // chunk_dim)
    end = n_chunks_total if last_chunk is None else min(n_chunks_total,
                                                        last_chunk + 1)
    last_ok = start_chunk - 1
    for chunk_idx in range(start_chunk, end):
        try:
            rng = np.random.default_rng(seed + chunk_idx)
            instances = create_coco_dataset_chunk(
                dataset, encode_fn,
                start_idx=chunk_idx * chunk_dim,
                chunk_dim=chunk_dim,
                n_pos_examples=n_pos_examples,
                n_part_pos_examples=n_part_pos_examples,
                sim_threshold=sim_threshold,
                augment=augment,
                part_pos_algorithm=part_pos_algorithm,
                rng=rng,
            )
            write_chunk(out_root, chunk_idx, instances,
                        dataset_name=dataset.dataset_name,
                        ann_file=dataset.ann_file)
            last_ok = chunk_idx
        except Exception as e:  # resumable: report and stop
            logger.error("Chunk %d creation failed: %s\n%s", chunk_idx, e,
                         traceback.format_exc())
            return last_ok
    write_meta(out_root, last_ok + 1)
    return last_ok
