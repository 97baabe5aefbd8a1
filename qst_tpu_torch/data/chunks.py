"""Chunked-JSON dataset storage with an LRU chunk cache — a host copy of
``qst_tpu/data/chunks.py`` (``tests/test_torch_data.py`` holds it to its
source).

Same on-disk format as the reference (``chunk_<i>.json`` files holding
``{dataset_name, ann_file, instances: [{id, reference, positive[],
part_positive[]}]}`` — reference coco_dataset_creation.py:53-57,81-87), so
datasets built by either framework interoperate.

The LRU cache replaces the reference's timestamp-sorted ``ValueSortedDict``
(reference quadruplet_dataset.py:325-370, O(log n) evict) with an
``OrderedDict`` move-to-end scheme (O(1) hit and evict).
"""

from __future__ import annotations

import json
import os
import re
from collections import OrderedDict
from typing import Any, Dict, Iterator, List, Optional

from qst_tpu_torch.core.config import (
    KEY_INSTANCES,
    KEY_POSITIVE,
    KEY_REFERENCE,
)

CHUNK_RE = re.compile(r"^chunk_(\d+)\.json$")
META_FILENAME = "chunk_n.json"


def chunk_path(root: str, idx: int) -> str:
    return os.path.join(root, f"chunk_{idx}.json")


def write_chunk(root: str, idx: int, instances: List[Dict[str, Any]],
                dataset_name: str = "", ann_file: str = "") -> str:
    os.makedirs(root, exist_ok=True)
    path = chunk_path(root, idx)
    with open(path, "w") as f:
        json.dump(
            {
                "dataset_name": dataset_name,
                "ann_file": ann_file,
                KEY_INSTANCES: instances,
            },
            f,
        )
    return path


def write_meta(root: str, n_chunks: int) -> None:
    """Chunk-count metadata (replaces the reference's torch.save(chunk_n.pt),
    dataset/main.py:59,74 — plain JSON needs no torch to read)."""
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, META_FILENAME), "w") as f:
        json.dump({"n_chunks": n_chunks}, f)


def read_meta(root: str) -> Optional[int]:
    path = os.path.join(root, META_FILENAME)
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return int(json.load(f)["n_chunks"])


def discover_chunks(root: str) -> List[int]:
    if not os.path.isdir(root):
        return []
    found = []
    for name in os.listdir(root):
        m = CHUNK_RE.match(name)
        if m:
            found.append(int(m.group(1)))
    return sorted(found)


class ChunkStore:
    """Random access over chunk files with a bounded LRU cache."""

    def __init__(self, root: str, chunk_indices: Optional[List[int]] = None,
                 cache_size: int = 30):
        if cache_size < 1:
            raise ValueError(f"cache_size must be >= 1, {cache_size} given")
        self.root = root
        if chunk_indices is None:
            n = read_meta(root)
            chunk_indices = list(range(n)) if n is not None else discover_chunks(root)
        if not chunk_indices:
            raise FileNotFoundError(f"no chunk files found under {root}")
        self.chunk_indices = list(chunk_indices)
        self.cache_size = cache_size
        self._cache: "OrderedDict[int, List[Dict[str, Any]]]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        # per-chunk instance counts (loaded lazily; chunks are fixed-size
        # except possibly the last, so probe first and last)
        self._lengths: Dict[int, int] = {}
        first = self.get_chunk(self.chunk_indices[0])
        self._default_len = len(first)
        if len(self.chunk_indices) > 1:
            self.get_chunk(self.chunk_indices[-1])

    def chunk_len(self, pos: int) -> int:
        idx = self.chunk_indices[pos]
        if idx not in self._lengths:
            self.get_chunk(idx)
        return self._lengths[idx]

    def get_chunk(self, idx: int) -> List[Dict[str, Any]]:
        if idx in self._cache:
            self.hits += 1
            self._cache.move_to_end(idx)
            return self._cache[idx]
        self.misses += 1
        with open(chunk_path(self.root, idx)) as f:
            data = json.load(f)
        instances = data[KEY_INSTANCES]
        self._lengths[idx] = len(instances)
        self._cache[idx] = instances
        if len(self._cache) > self.cache_size:
            self._cache.popitem(last=False)
        return instances

    @property
    def n_chunks(self) -> int:
        return len(self.chunk_indices)

    def __len__(self) -> int:
        # Exact total: fixed-dim chunks + possibly short last chunk.
        total = 0
        for pos in range(self.n_chunks - 1):
            idx = self.chunk_indices[pos]
            total += self._lengths.get(idx, self._default_len)
        total += self.chunk_len(self.n_chunks - 1)
        return total

    def locate(self, index: int) -> tuple[int, int]:
        """Global instance index → (chunk file idx, local idx). Assumes all
        chunks except the last have the same length (the on-disk invariant,
        reference quadruplet_dataset.py:25-28)."""
        pos = index // self._default_len
        local = index % self._default_len
        if pos >= self.n_chunks:
            raise IndexError(index)
        return self.chunk_indices[pos], local

    def get_instance(self, index: int) -> Dict[str, Any]:
        cidx, local = self.locate(index)
        chunk = self.get_chunk(cidx)
        if local >= len(chunk):
            raise IndexError(index)
        return chunk[local]

    def iter_instances(self) -> Iterator[Dict[str, Any]]:
        for idx in self.chunk_indices:
            yield from self.get_chunk(idx)

    def all_positive_captions(self) -> List[str]:
        """Flat caption pool (references + positives) — the candidate source
        for negative mining."""
        pool: List[str] = []
        for inst in self.iter_instances():
            pool.append(inst[KEY_REFERENCE])
            pool.extend(inst.get(KEY_POSITIVE, []))
        return pool
