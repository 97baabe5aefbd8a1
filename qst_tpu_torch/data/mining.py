"""Negative mining — counterpart of ``qst_tpu/data/mining.py``, on the
device that holds the embeddings.

- ``mine_negatives``: one cosine product (B, N) and a masked selection, as
  plain PyTorch (the JAX package computes it outside any Pallas kernel) —
  candidates with cos ≤ threshold are valid, selection is either
  hard-contrastive top-k (largest cos among valid) or uniform among valid,
  with the least-bad candidates filling a short row and marked invalid.
- ``replicate_short``: the host's replicate-if-short fallback (a copy).
- ``EmbeddingTable``: the caption pool's embedding matrix, kept on the
  encoder's device and refreshed every N steps by one batched encode.
- ``NegativeMiner``: table + selection + retries over fresh candidate
  sub-pools + the fallback.

Ties and randomness. The selection is a stable descending sort of the
scores, so equal scores keep the lower index first, as ``jax.lax.top_k``
does. Random mode ranks the valid candidates by i.i.d. uniform keys from a
``torch.Generator`` (seeded from (seed, attempt), as the JAX miner folds the
attempt into its key): the Gumbel-top-k of ``jax.random.gumbel`` ranks by a
monotone function of such keys, so the selection has the same distribution
— uniform among valid — but not the same draws. The numpy ``Generator``
behind the candidate sub-pools and ``replicate_short`` is the JAX miner's,
so hard-contrastive mining, retries included, picks what it picks.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from qst_tpu_torch.core.config import NEGATIVE_SIM_THRESHOLD
from qst_tpu_torch.core.device import device_of
from qst_tpu_torch.ops.distances import l2_normalize
from qst_tpu_torch.retrieval.retriever import encode_keep_device

# Mining modes (reference quadruplet_dataset.py:17-19).
HARD_CONTRASTIVE_TRAIN = 1
HARD_CONTRASTIVE_TEST = 0
RANDOM = -1


def mine_negatives(
    anchor_emb: torch.Tensor,   # (B, D)
    table_emb: torch.Tensor,    # (N, D) candidate-pool embeddings
    generator: Optional[torch.Generator],
    n_neg: int,
    hard: bool,
    threshold: float = NEGATIVE_SIM_THRESHOLD,
    forbidden: Optional[torch.Tensor] = None,  # (B, N) bool: True = exclude
) -> tuple[torch.Tensor, torch.Tensor]:
    """→ (indices (B, n_neg) into the table, validity mask (B, n_neg)), on
    the table's device.

    Valid candidates have cos(anchor, cand) ≤ threshold and are not
    forbidden. Hard mode picks the valid candidates with the LARGEST cosine
    (hardest negatives); random mode picks uniformly among valid, by keys
    from ``generator`` (on the table's device). If fewer than ``n_neg`` are
    valid, the least-invalid candidates fill the rest and the mask marks
    them (the host replicates valid picks instead — the reference's
    replicate-if-short fallback)."""
    a = l2_normalize(anchor_emb.float())
    t = l2_normalize(table_emb.float())
    cos = a @ t.T                                              # (B, N)
    valid = cos <= threshold
    if forbidden is not None:
        valid = valid & ~forbidden
    if hard:
        # hardest = largest cos among valid; push invalid to -inf
        keys = cos
    else:
        keys = torch.rand(cos.shape, generator=generator, device=cos.device)
    scores = torch.where(valid, keys, torch.full_like(keys, float("-inf")))

    k = min(n_neg, table_emb.shape[0])
    top_scores, top_idx = torch.sort(scores, dim=1, descending=True, stable=True)
    top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
    ok = torch.isfinite(top_scores)
    if k < n_neg:  # tiny pool: pad; host replicate_short fills from valid
        pad = n_neg - k
        top_idx = torch.cat([top_idx, top_idx[:, :1].expand(-1, pad)], dim=1)
        ok = torch.cat([ok, torch.zeros((ok.shape[0], pad), dtype=torch.bool,
                                        device=ok.device)], dim=1)
    return top_idx, ok


def replicate_short(indices: np.ndarray, ok: np.ndarray,
                    rng: np.random.Generator) -> np.ndarray:
    """Host fallback mirroring reference quadruplet_dataset.py:266-268:
    rows with < n valid picks repeat their valid picks; rows with none keep
    the (least-bad) device picks."""
    out = indices.copy()
    for i in range(out.shape[0]):
        good = indices[i][ok[i]]
        if 0 < len(good) < out.shape[1]:
            bad_slots = np.where(~ok[i])[0]
            out[i, bad_slots] = rng.choice(good, size=len(bad_slots))
    return out


class EmbeddingTable:
    """Caption-pool embeddings on the device with periodic refresh.

    ``refresh`` re-encodes the pool with ``encode_fn`` in one batched call,
    keeping the embeddings where the encoder leaves them (a
    ``SentenceEncoder.encode`` keeps them on its device; a function that
    returns host arrays has them moved to ``device``, by default the GPU).
    """

    def __init__(self, captions: Sequence[str],
                 encode_fn: Callable[[Sequence[str]], Any],
                 refresh_steps: int = 500,
                 max_pool: int = 100_000,
                 rng: Optional[np.random.Generator] = None,
                 device: Any = None):
        rng = rng or np.random.default_rng(0)
        captions = list(captions)
        if len(captions) > max_pool:
            sel = rng.choice(len(captions), size=max_pool, replace=False)
            captions = [captions[i] for i in sel]
        if not captions:
            raise ValueError("empty caption pool")
        self.captions: List[str] = captions
        self.encode_fn = encode_fn
        self.refresh_steps = refresh_steps
        self.device = device
        self._emb: Optional[torch.Tensor] = None
        self._last_refresh = -1

    @property
    def embeddings(self) -> torch.Tensor:
        if self._emb is None:
            self.refresh(step=0)
        assert self._emb is not None
        return self._emb

    def maybe_refresh(self, step: int) -> None:
        if self._emb is None or step - self._last_refresh >= self.refresh_steps:
            self.refresh(step)

    def refresh(self, step: int) -> None:
        emb = encode_keep_device(self.encode_fn, self.captions)
        self._emb = torch.as_tensor(emb, device=device_of(emb, self.device))
        self._last_refresh = step

    def lookup(self, indices: np.ndarray) -> List[List[str]]:
        return [[self.captions[int(j)] for j in row] for row in indices]


class NegativeMiner:
    """End-to-end batched miner: anchors (text) → negative captions.

    Combines the embedding table, the selection on the table's device, retry
    semantics, and the replicate-if-short host fallback.

    Retry semantics match the reference (quadruplet_dataset.py:199-239):
    each attempt draws a FRESH random candidate sub-pool (the reference
    samples a new random chunk and ≤5·n candidate captions per attempt), so
    a row whose attempt-1 pool had zero valid candidates can succeed on
    attempt 2 against different candidates — ``max_attempts`` observably
    changes outcomes in both random and hard-contrastive mode.

    ``mine`` may run on a data-loading thread (the trainer's prefetch) while
    the main thread trains: the miner holds its own encoder and shares no
    state with the train step.
    """

    def __init__(self, table: EmbeddingTable,
                 encode_fn: Callable[[Sequence[str]], Any],
                 mode: int = RANDOM,
                 threshold: float = NEGATIVE_SIM_THRESHOLD,
                 max_attempts: int = 3,
                 pool_factor: int = 5,
                 seed: int = 14):
        if pool_factor < 1:
            raise ValueError(f"pool_factor must be >= 1, got {pool_factor}")
        self.table = table
        self.encode_fn = encode_fn
        self.mode = mode
        self.threshold = threshold
        self.max_attempts = max_attempts
        # Reference draws <= 5*n candidates per attempt
        # (quadruplet_dataset.py:213-225); pool size = pool_factor * n_neg.
        self.pool_factor = pool_factor
        self._seed = seed
        self._rng = np.random.default_rng(seed)
        self._calls = 0

    def _generator(self, device: torch.device) -> torch.Generator:
        """The random-mode keys' generator of this attempt: a function of
        (seed, attempt), as ``fold_in(key, calls)`` is in the JAX miner."""
        state = np.random.SeedSequence([self._seed, self._calls]).generate_state(1, np.uint64)
        return torch.Generator(device=device).manual_seed(int(state[0]))

    def mine(self, anchors: Sequence[str], n_neg: int, step: int = 0,
             anchor_emb: Optional[Any] = None) -> List[List[str]]:
        self.table.maybe_refresh(step)
        table = self.table.embeddings
        if anchor_emb is None:
            anchor_emb = encode_keep_device(self.encode_fn, list(anchors))
        a = torch.as_tensor(anchor_emb, device=table.device)
        hard = self.mode in (HARD_CONTRASTIVE_TRAIN, HARD_CONTRASTIVE_TEST)
        n_table = len(self.table.captions)
        pool_size = min(n_table, self.pool_factor * n_neg)
        idx = ok = None
        for _ in range(max(1, self.max_attempts)):
            self._calls += 1
            gen = None if hard else self._generator(table.device)
            # Fresh candidate sub-pool per attempt (one shared pool for the
            # batch — the batched analogue of the reference's fresh random
            # chunk per item per attempt).
            sub = self._rng.choice(n_table, size=pool_size, replace=False)
            sub_emb = table[torch.from_numpy(sub).to(table.device)]
            idx_t, ok_t = mine_negatives(a, sub_emb, gen, n_neg, hard,
                                         threshold=self.threshold)
            idx_np = sub[idx_t.cpu().numpy()]  # map sub-pool → table indices
            ok_np = ok_t.cpu().numpy()
            if idx is None:
                idx, ok = idx_np, ok_np
            else:  # keep previous rows that were already fully valid
                need = ~ok.all(axis=1)
                idx[need], ok[need] = idx_np[need], ok_np[need]
            if ok.all():
                break
        assert idx is not None and ok is not None
        idx = replicate_short(idx, ok, self._rng)
        return self.table.lookup(idx)
