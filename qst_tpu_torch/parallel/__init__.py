"""Parallel layers of the port — counterpart of ``qst_tpu/parallel``.
Ported: context-parallel attention (``context.py``). Parameter sharding
(``sharding.py``) and pipeline parallelism (``pipeline.py``) belong to the
training side and are not ported yet."""

from qst_tpu_torch.parallel.context import (
    context_parallel_attention,
    full_attention,
    ring_attention,
)

__all__ = ["full_attention", "context_parallel_attention", "ring_attention"]
