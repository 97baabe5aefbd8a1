"""Parallel layers of the port — counterpart of ``qst_tpu/parallel``:
parameter sharding rules and the tensor-parallel and data-parallel pieces
of the train step (``sharding.py``), pipeline parallelism
(``pipeline.py``) and context-parallel attention (``context.py``)."""

from qst_tpu_torch.parallel.sharding import (
    create_sharded,
    spec_for_param,
    state_shardings,
    tree_param_specs,
    tree_shardings,
)

__all__ = [
    "spec_for_param",
    "tree_param_specs",
    "tree_shardings",
    "state_shardings",
    "create_sharded",
]

from qst_tpu_torch.parallel.context import (
    context_parallel_attention,
    full_attention,
    ring_attention,
)

__all__ += ["full_attention", "context_parallel_attention", "ring_attention"]
