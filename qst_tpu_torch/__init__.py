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

Ported so far: serving (``SentenceEncoder`` encode through the fused layer,
K1; exact search through bucket maxima, K4, and the winning-bucket rescore,
K5; ``Retriever`` and ``RetrievalServer``), training (``Trainer`` through K1
with dropout, the layer backward K2 and the fused loss K3) and IVF retrieval
(``IVFIndex`` through the probed-cell scorer K6, ``UpdatableIndex``, and the
``cli.index_main`` entry point). Entry points run on the GPU unless given
another ``device`` (``core/device.py``).
"""

__version__ = "0.1.0"
