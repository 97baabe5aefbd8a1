"""Encoder models, tokenizers and weight import (counterpart of
``qst_tpu/models``)."""
