"""A frozen copy of the training forward's dropout draws.

The masks are a pure function of (seed, step): murmur3's 32-bit finaliser
of an element's index xor a site's seed gives 31 uniform bits, kept when
below ``(1 − rate)·(2³¹ − 1)``, a kept element scaled by float32(1/(1 − rate)).
A step's base seed hashes the step under the run's seed (tag 7), each
layer's seed hashes the layer under the base (tag 8); the embeddings' mask
takes the base (tag 9). Inside a layer the batch is cut into blocks of
``nb`` sequences: sequence b takes seed ``layer_seed ^ (b // nb)·0x9E3779B9``,
the attention probabilities of head h tag 16 + (b % nb)·heads + h over
index q·S + k, the attention output tag 0 and the feed-forward output tag 1
over index ((b % nb)·S + s)·H + c.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
TAG_STEP, TAG_LAYERS, TAG_EMBED = 7, 8, 9


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    return (h * (c & 0xFFFF) + (((h * (c >> 16)) & 0xFFFF) << 16)) & M32


def hash31(idx: torch.Tensor, seed, tag) -> torch.Tensor:
    """31 bits from int64 ``idx`` (< 2³²) under ``seed`` and ``tag`` (ints or
    int64 tensors that broadcast against ``idx``)."""
    h = idx ^ ((seed + tag * GOLDEN) & M32)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h & 0x7FFFFFFF


def hash31_int(value: int, seed: int, tag: int) -> int:
    return int(hash31(torch.tensor([value & M32]), seed & M32, tag)[0])


def step_seeds(seed: int, step: int, num_layers: int) -> Tuple[int, List[int]]:
    """(the step's base seed, each layer's seed) of train step ``step``."""
    base = hash31_int(step, seed, TAG_STEP)
    return base, [hash31_int(layer, base, TAG_LAYERS) for layer in range(num_layers)]


def _keep(bits: torch.Tensor, rate: float) -> torch.Tensor:
    threshold = int((1.0 - rate) * 2147483647.0)
    return (bits < threshold).float() * float(np.float32(1.0 / (1.0 - rate)))


def _block_seed(layer_seed: int, b: torch.Tensor, nb: int) -> torch.Tensor:
    return ((layer_seed & M32) ^ ((b // nb) * GOLDEN)) & M32


def embedding_mask(shape, base: int, rate: float, device) -> torch.Tensor:
    idx = torch.arange(int(np.prod(shape)), dtype=torch.int64, device=device).reshape(shape)
    return _keep(hash31(idx, base, TAG_EMBED), rate)


def attention_mask(B: int, heads: int, S: int, layer_seed: int, rate: float, nb: int,
                   device) -> torch.Tensor:
    """(B, heads, S, S) scale mask of the attention probabilities."""
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)  # noqa: E731
    b, h = ar(B)[:, None, None, None], ar(heads)[None, :, None, None]
    idx = (ar(S)[:, None] * S + ar(S)[None, :])[None, None]
    return _keep(hash31(idx, _block_seed(layer_seed, b, nb), 16 + (b % nb) * heads + h), rate)


def hidden_mask(B: int, S: int, H: int, layer_seed: int, rate: float, nb: int, tag: int,
                device) -> torch.Tensor:
    """(B, S, H) scale mask of a layer's attention (tag 0) or FFN (tag 1) output."""
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)  # noqa: E731
    b, s, c = ar(B)[:, None, None], ar(S)[None, :, None], ar(H)[None, None, :]
    idx = ((b % nb) * S + s) * H + c
    return _keep(hash31(idx, _block_seed(layer_seed, b, nb), tag), rate)
