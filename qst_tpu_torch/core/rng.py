"""RNG streams — counterpart of ``qst_tpu/core/rng.py`` on ``torch.Generator``.

A stream hands out fresh generators, each a pure function of (seed, the
counter, the fork tags): :meth:`RngStream.next` gives the next one,
:meth:`RngStream.fork` an independent child stream for a tag, and
:meth:`RngStream.numpy` a host-side numpy ``Generator`` drawn from the
stream. JAX's ``fold_in(key, n)`` becomes a ``numpy.random.SeedSequence``
over the path of integers from the seed, so the draws are the port's own:
equal between runs, not equal to ``jax.random``'s.
"""

from __future__ import annotations

import os
import random as _pyrandom
import zlib
from typing import Iterator, Tuple

import numpy as np
import torch


class RngStream:
    """A named, fork-on-demand stream of ``torch.Generator`` objects.

    Each call to :meth:`next` returns a fresh generator seeded from the
    stream's path with an incrementing counter folded in; :meth:`fork`
    derives an independent child stream from a string tag. Generators are
    CPU generators."""

    def __init__(self, seed: int | Tuple[int, ...], name: str = "root"):
        self._path = (int(seed),) if isinstance(seed, int) else tuple(seed)
        self._counter = 0
        self.name = name

    def _seed_of(self, *more: int) -> int:
        state = np.random.SeedSequence([*self._path, *more]).generate_state(1, np.uint64)[0]
        return int(state)

    def next(self) -> torch.Generator:
        self._counter += 1
        return torch.Generator().manual_seed(self._seed_of(self._counter))

    def fork(self, tag: str) -> "RngStream":
        # a stable hash: Python's hash() of a str changes between processes
        h = zlib.crc32(tag.encode()) & 0x7FFFFFFF
        return RngStream((*self._path, 0, h), name=tag)

    def numpy(self) -> np.random.Generator:
        """A host-side numpy Generator seeded from this stream (for data
        sampling off the device path)."""
        seed = int(torch.randint(0, 2**31 - 1, (), generator=self.next()))
        return np.random.default_rng(seed)


def seed_everything(seed: int) -> RngStream:
    """Seed host-side RNGs (python/numpy/PYTHONHASHSEED) and torch's global
    generators, and return the root stream. The host seeding mirrors the
    reference's intent (dataset/__init__.py:14-21) but happens explicitly,
    never at import."""
    _pyrandom.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    return RngStream(seed)


def key_iter(seed: int) -> Iterator[torch.Generator]:
    stream = RngStream(seed)
    while True:
        yield stream.next()
