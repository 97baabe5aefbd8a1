"""qst_tpu_torch — the PyTorch/CUDA port of ``qst_tpu``.

A second package beside ``qst_tpu`` with the same layout and module names,
so each module's counterpart sits at the same path under ``qst_tpu/``. It
imports ``torch``, ``numpy`` and the standard library only — never ``jax``,
``flax`` or ``qst_tpu`` — so it runs on a machine without JAX.

Every Pallas kernel of the ported slice is a hand-written CUDA kernel for
Hopper (``sm_90a``) under ``kernels/csrc/``, built with ``nvcc`` at first use
(``kernels/build.py``). Each kernel's wrapper keeps a plain PyTorch version
beside it: CPU tensors take the plain version, CUDA tensors launch the kernel
or raise.

Every module and public name of ``qst_tpu`` has its counterpart here, but
for the differences ``tests/test_torch_surface.py`` lists with their
reasons: serving (``SentenceEncoder`` through the fused layer K1, exact
search through K4 and K5, ``Retriever``, ``RetrievalServer``), training
(``Trainer`` through K1 with dropout, the layer backward K2 and the fused
loss K3, the captured multi-step), the IVF, PQ, IVF-PQ, streamed and
updatable indexes (K6 scores IVF's probed cells), evaluation and mining,
dataset construction and augmentation, BERT / MPNet / RoBERTa trunks, the
cross-encoder, MLM and Marian, checkpoint directories, long documents
through flash attention (K7, K8), meshes of devices within and across
processes, the configs (``load_config`` reads a run's
``experiment_config.json``) and the CLIs. Entry points run on the GPU unless
given another ``device`` (``core/device.py``).
"""

__version__ = "0.1.0"
