"""Tensor ops and kernel wrappers (counterpart of ``qst_tpu/ops``)."""
