"""Quadruplet dataset: map-style access + batched iteration — counterpart
of ``qst_tpu/data/quadruplet_dataset.py``.

Over chunked JSON files with an LRU chunk cache, each access samples
``n_pos`` positives and ``n_part_pos`` part-positives without duplicates
(``choose_examples``) and ``n_neg`` negatives: mined by a
``data.mining.NegativeMiner`` against the caption pool when one is
attached (``miner=`` or ``from_config(encode_fn=...)``), else uniformly from
other instances (``_random_negatives``). With a step, sampling is a pure
function of (seed, step), so the draws are qst_tpu's draws for the same
chunks.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

from qst_tpu_torch.core.config import (
    KEY_NEGATIVE,
    KEY_PART_POSITIVE,
    KEY_POSITIVE,
    KEY_REFERENCE,
)
from qst_tpu_torch.data.chunks import ChunkStore
from qst_tpu_torch.data.mining import RANDOM, NegativeMiner


def choose_examples(pool: Sequence[str], n: int,
                    rng: np.random.Generator) -> List[str]:
    """Sample n captions without duplicates where possible, replicating when
    the pool is short (reference _choose_examples semantics)."""
    pool = list(pool)
    if not pool:
        raise ValueError("empty example pool")
    if n <= len(pool):
        idx = rng.choice(len(pool), size=n, replace=False)
    else:
        idx = np.concatenate([
            rng.permutation(len(pool)),
            rng.choice(len(pool), size=n - len(pool), replace=True),
        ])
    return [pool[i] for i in idx]


class QuadrupletDataset:
    def __init__(
        self,
        root: str,
        chunk_indices: Optional[List[int]] = None,
        hard_contrastive_mode: int = RANDOM,
        n_pos: int = 1,
        n_part_pos: int = 1,
        n_neg: int = 1,
        cache_size: int = 30,
        transform: Optional[Callable[[Dict[str, Any]], Any]] = None,
        miner: Optional[NegativeMiner] = None,
        seed: int = 14,
    ):
        for name, v in (("n_pos", n_pos), ("n_part_pos", n_part_pos),
                        ("n_neg", n_neg)):
            if v < 1:
                raise ValueError(f"{name} must be >= 1, {v} given")
        self.store = ChunkStore(root, chunk_indices, cache_size=cache_size)
        self.hard_contrastive_mode = hard_contrastive_mode
        self.n_pos = n_pos
        self.n_part_pos = n_part_pos
        self.n_neg = n_neg
        self.transform = transform
        self.miner = miner
        self._seed = seed
        self._rng = np.random.default_rng(seed)

    @classmethod
    def from_config(cls, cfg, encode_fn=None,
                    transform=None) -> "QuadrupletDataset":
        """Build from a :class:`qst_tpu_torch.core.config.DataConfig`. When an
        ``encode_fn`` is given, a NegativeMiner is attached with the config's
        threshold/mode/refresh settings; its table lives where ``encode_fn``
        leaves the embeddings."""
        from qst_tpu_torch.data.mining import EmbeddingTable

        ds = cls(
            root=cfg.root,
            chunk_indices=list(range(cfg.n_chunks)) if cfg.n_chunks else None,
            hard_contrastive_mode=cfg.hard_contrastive_mode,
            n_pos=cfg.n_pos, n_part_pos=cfg.n_part_pos, n_neg=cfg.n_neg,
            cache_size=cfg.cache_size, transform=transform, seed=cfg.seed)
        if encode_fn is not None:
            table = EmbeddingTable(ds.store.all_positive_captions(),
                                   encode_fn,
                                   refresh_steps=cfg.mining_refresh_steps)
            ds.miner = NegativeMiner(
                table, encode_fn, mode=cfg.hard_contrastive_mode,
                threshold=cfg.neg_sim_threshold,
                max_attempts=cfg.neg_max_attempts, seed=cfg.seed)
        return ds

    def __len__(self) -> int:
        return len(self.store)

    # -- sampling ----------------------------------------------------------
    def _sample_instance(self, index: int,
                         rng: np.random.Generator) -> Dict[str, Any]:
        inst = self.store.get_instance(index)
        return {
            "id": inst.get("id", index),
            KEY_REFERENCE: inst[KEY_REFERENCE],
            KEY_POSITIVE: choose_examples(inst[KEY_POSITIVE], self.n_pos, rng),
            KEY_PART_POSITIVE: choose_examples(
                inst[KEY_PART_POSITIVE], self.n_part_pos, rng),
        }

    def _random_negatives(self, anchors: List[str],
                          rng: np.random.Generator) -> List[List[str]]:
        """Miner-less fallback: uniform captions from other instances (no
        similarity filter). Used only when no miner is configured."""
        out = []
        n_total = len(self.store)
        for _ in anchors:
            negs = []
            for _ in range(self.n_neg):
                j = int(rng.integers(0, n_total))
                other = self.store.get_instance(j)
                pool = [other[KEY_REFERENCE]] + list(other.get(KEY_POSITIVE, []))
                negs.append(pool[int(rng.integers(0, len(pool)))])
            out.append(negs)
        return out

    def sample_batch(self, indices: Sequence[int],
                     step: Optional[int] = None) -> List[Dict[str, Any]]:
        """With ``step``, sampling is a pure function of (seed, step) —
        a resumed training run replays the exact draws the interrupted run
        would have made; without it (map-style access), the mutable stream
        resamples per call like the reference's ``__getitem__``."""
        rng = (self._rng if step is None
               else np.random.default_rng(
                   np.random.SeedSequence([self._seed, int(step)])))
        items = [self._sample_instance(i, rng) for i in indices]
        anchors = [it[KEY_REFERENCE] for it in items]
        if self.miner is not None:
            negs = self.miner.mine(anchors, self.n_neg, step=step or 0)
        else:
            negs = self._random_negatives(anchors, rng)
        for it, neg in zip(items, negs):
            it[KEY_NEGATIVE] = list(neg)
        if self.transform is not None:
            return [self.transform(it) for it in items]
        return items

    # -- map-style access (parity surface) ----------------------------------
    def __getitem__(self, index: Union[int, Sequence[int]]):
        if isinstance(index, (list, tuple, np.ndarray)):
            return self.sample_batch([int(i) for i in index])
        return self.sample_batch([int(index)])[0]

    # -- batched iteration (training path) ----------------------------------
    def iter_batches(self, batch_size: int, shuffle: bool = True,
                     drop_last: bool = True, epoch: int = 0,
                     step_offset: int = 0, start_batch: int = 0
                     ) -> Iterator[List[Dict[str, Any]]]:
        """``start_batch`` skips the first batches of the (deterministic
        per-epoch) order without sampling them — the trainer's
        preemption-resume fast-forward."""
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(hash((epoch, 14)) & 0x7FFFFFFF).shuffle(order)
        step = step_offset
        for start in range(start_batch * batch_size, len(order), batch_size):
            idx = order[start:start + batch_size]
            if len(idx) < batch_size:
                if drop_last:
                    return
                # pad by wrapping — fixed batch shapes
                idx = np.concatenate([idx, order[: batch_size - len(idx)]])
            yield self.sample_batch([int(i) for i in idx], step=step)
            step += 1

    @property
    def cache_stats(self) -> Dict[str, int]:
        return {"hits": self.store.hits, "misses": self.store.misses}
