"""Encoder configuration — a copy of ``EncoderConfig`` and its presets from
``qst_tpu/core/config.py``.

The port cannot import the original: importing ``qst_tpu.core`` pulls in JAX.
``tests/test_torch_ops.py`` holds this copy to its source field for field,
preset for preset.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class EncoderConfig:
    """BERT-family encoder hyperparameters.

    Presets mirror the reference's default checkpoints: all-MiniLM-L6-v2
    and all-mpnet-base-v2.
    """

    name: str = "minilm-l6"
    arch: str = "bert"  # "bert" | "mpnet" | "roberta"
    vocab_size: int = 30522
    hidden_size: int = 384
    num_layers: int = 6
    num_heads: int = 12
    intermediate_size: int = 1536
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    max_seq_length: int = 128
    pooling: str = "mean"  # "mean" | "cls" | "max"
    normalize: bool = True
    dtype: str = "bfloat16"  # compute dtype; params stay float32
    pad_token_id: int = 0
    use_flash_attention: bool = False
    remat: bool = False
    # Run each transformer layer through the fused layer kernel
    # (ops/fused_layer.py: K1 on CUDA, its plain version on the CPU).
    use_fused_layer: bool = False
    # sequences per grid step of the TPU kernel; kept for field parity with
    # qst_tpu — the CUDA kernels need no batch blocking
    fused_nb: int = 8

    @staticmethod
    def minilm_l6(**overrides: Any) -> "EncoderConfig":
        return EncoderConfig(**{**dict(name="minilm-l6"), **overrides})

    @staticmethod
    def mpnet_base(**overrides: Any) -> "EncoderConfig":
        base = dict(
            name="mpnet-base",
            arch="mpnet",
            vocab_size=30527,
            hidden_size=768,
            num_layers=12,
            num_heads=12,
            intermediate_size=3072,
            max_position_embeddings=514,
            pad_token_id=1,
        )
        base.update(overrides)
        return EncoderConfig(**base)

    @staticmethod
    def roberta_large(**overrides: Any) -> "EncoderConfig":
        """The reference's cross-encoder trunk (cross-encoder/stsb-roberta-large)."""
        base = dict(
            name="roberta-large",
            arch="roberta",
            vocab_size=50265,
            hidden_size=1024,
            num_layers=24,
            num_heads=16,
            intermediate_size=4096,
            max_position_embeddings=514,
            type_vocab_size=1,
            layer_norm_eps=1e-5,
            pad_token_id=1,
            pooling="cls",
        )
        base.update(overrides)
        return EncoderConfig(**base)

    @staticmethod
    def tiny(**overrides: Any) -> "EncoderConfig":
        """Small config for tests."""
        base = dict(
            name="tiny",
            vocab_size=512,
            hidden_size=64,
            num_layers=2,
            num_heads=4,
            intermediate_size=128,
            max_position_embeddings=64,
            max_seq_length=32,
            dtype="float32",
        )
        base.update(overrides)
        return EncoderConfig(**base)
