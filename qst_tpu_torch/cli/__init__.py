"""Command-line entry points (counterpart of ``qst_tpu/cli``)."""
