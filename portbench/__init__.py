"""The benchmark of ``qst_tpu_torch``, the PyTorch/CUDA port, on NVIDIA cards.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell once (``run.py``). Cells, configurations, traffic mixes and
per-layer metrics are files of their own, found by name (``registry.py``).
The reference that decides ``correct`` is ``reference/``, which imports
nothing of the program.
"""
