"""Hand-written CUDA kernels for Hopper (``csrc/``) and their build
(``build.py``). The Python wrappers live beside their plain versions in
``qst_tpu_torch/ops``."""
