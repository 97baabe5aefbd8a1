"""Mutable exact index for serving: add/remove documents online —
counterpart of ``qst_tpu/retrieval/updatable.py``.

``UpdatableIndex`` keeps a fixed-capacity device buffer of L2-normalized
rows with a valid count: adds write rows after the last valid one, removes
are swap-with-last (all of one call's moves applied as a single permutation
gather), and search masks slots at or past the count.

Concurrency: the whole index state (buffer, id tuple, id→pos map) lives in
one attribute swapped atomically under the GIL, and every update builds a
new buffer tensor instead of writing into the current one — a search that
snapshotted the previous state keeps valid rows and a consistent id mapping
while an add/remove publishes the next state (the ``RetrievalServer``'s
batched searches run on collector threads concurrent with ``POST/DELETE
/docs``). Updates themselves are not thread-safe against each other —
serialize writers (the HTTP server funnels them through one lock).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from qst_tpu_torch.core.device import resolve_device
from qst_tpu_torch.ops.distances import l2_normalize


def _masked_search(queries: torch.Tensor, buffer: torch.Tensor, n_valid: int, k: int):
    """Dot-product top-k over the first ``n_valid`` rows of the whole
    buffer (one shape whatever the count). Buffer rows are pre-normalized
    for cosine semantics."""
    s = l2_normalize(queries.float()) @ buffer.T
    col = torch.arange(buffer.shape[0], device=buffer.device)
    return torch.topk(torch.where(col[None, :] < n_valid, s, float("-inf")), k, dim=1)


class EmptyIndexError(RuntimeError):
    """A search over an index that holds no document."""


class UpdatableIndex:
    def __init__(self, dim: int, capacity: int = 65536, device: Any = None):
        """The buffer lives on ``device`` (default: the GPU)."""
        if capacity < 1 or dim < 1:
            raise ValueError("dim and capacity must be >= 1")
        self.dim = dim
        self.capacity = capacity
        self.device = resolve_device(device)
        # (buffer, ids tuple, id->pos dict) — replaced wholesale per update
        self._state: Tuple[torch.Tensor, tuple, Dict] = (
            torch.zeros((capacity, dim), dtype=torch.float32, device=self.device), (), {})

    def __len__(self) -> int:
        return len(self._state[1])

    @property
    def n_docs(self) -> int:
        """Current live document count (the serving /healthz figure)."""
        return len(self._state[1])

    @property
    def _buffer(self) -> torch.Tensor:  # kept for introspection/tests
        return self._state[0]

    @property
    def ids(self) -> tuple:
        return self._state[1]

    def add(self, embeddings, ids: Sequence) -> None:
        buffer, cur_ids, pos = self._state
        emb = torch.as_tensor(embeddings).float()
        if emb.ndim != 2 or emb.shape[1] != self.dim:
            raise ValueError(f"expected (N, {self.dim}) embeddings")
        if len(ids) != emb.shape[0]:
            raise ValueError("ids length mismatch")
        dupes = [i for i in ids if i in pos]
        if dupes:
            raise KeyError(f"ids already present: {dupes[:5]}")
        if len(set(ids)) != len(ids):
            raise KeyError("duplicate ids within one add")
        if len(cur_ids) + len(ids) > self.capacity:
            raise RuntimeError(
                f"capacity {self.capacity} exceeded "
                f"({len(cur_ids)} + {len(ids)})")
        start = len(cur_ids)
        # a new buffer, never an in-place write: concurrent searches may
        # still hold the previous one
        new_buffer = buffer.clone()
        new_buffer[start:start + len(ids)] = l2_normalize(emb.to(self.device))
        new_pos = dict(pos)
        for j, i in enumerate(ids):
            new_pos[i] = start + j
        self._state = (new_buffer, cur_ids + tuple(ids), new_pos)

    def remove(self, ids: Sequence) -> None:
        buffer, cur_ids, pos = self._state
        id_list: List = list(cur_ids)
        new_pos = dict(pos)
        # simulate every swap-with-last on the host id list first …
        for i in ids:
            if i not in new_pos:
                raise KeyError(f"unknown id: {i!r}")
            p = new_pos.pop(i)
            last = len(id_list) - 1
            last_id = id_list[last]
            if p != last:
                id_list[p] = last_id
                new_pos[last_id] = p
            id_list.pop()
        # … then apply all row moves as one device gather: slot p must end
        # up holding the row of the id that now lives there (identity for
        # untouched slots; old positions come from the pre-remove map)
        perm = np.arange(self.capacity, dtype=np.int64)
        for p, i in enumerate(id_list):
            old_p = pos[i]
            if old_p != p:
                perm[p] = old_p
        new_buffer = (buffer if (perm == np.arange(self.capacity)).all()
                      else buffer[torch.from_numpy(perm).to(self.device)])
        self._state = (new_buffer, tuple(id_list), new_pos)

    def search(self, queries, k: int = 10) -> Tuple[np.ndarray, List[list]]:
        """→ (scores (Q, k'), per-query id lists), k' = min(k, len(self))."""
        buffer, cur_ids, _ = self._state    # one consistent snapshot
        if not cur_ids:
            raise EmptyIndexError("index is empty")
        k = min(k, len(cur_ids))
        s, i = _masked_search(torch.as_tensor(queries, device=self.device),
                              buffer, len(cur_ids), k)
        return s.cpu().numpy(), [[cur_ids[j] for j in row] for row in i.cpu().numpy()]
