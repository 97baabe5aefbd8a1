"""``idle_pct.train``'s reading in the encode cells, where it moves
``encode_docs_per_s``: the same reader over the same observations."""

from portbench.registry import metric

KERNELS = metric("idle_pct.train").KERNELS
read = metric("idle_pct.train").read
