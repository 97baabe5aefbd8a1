"""Typed configuration — copies of ``EncoderConfig`` (with its presets),
``LossConfig``, ``DataConfig`` and ``TrainConfig``, of the constants they
and the data modules use, and of ``save_config``, from
``qst_tpu/core/config.py``.

The port cannot import the original: importing ``qst_tpu.core`` pulls in JAX.
``tests/test_torch_ops.py`` holds these copies to their source field for
field, preset for preset, check for check.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Any, Dict, Tuple

# Defaults mirroring the reference's semantics (qst_tpu/core/config.py:24-47)
RANDOM_SEED = 14
DEFAULT_GAMMA = 0.6
NEGATIVE_SIM_THRESHOLD = 0.2
CHUNK_DIM = 500

# Canonical instance/feature keys
KEY_REFERENCE = "reference"
KEY_POSITIVE = "positive"
KEY_PART_POSITIVE = "part_positive"
KEY_NEGATIVE = "negative"
KEY_INSTANCES = "instances"
QUADRUPLET_KEYS: Tuple[str, str, str, str] = (
    KEY_REFERENCE,
    KEY_POSITIVE,
    KEY_PART_POSITIVE,
    KEY_NEGATIVE,
)

REDUCTIONS = frozenset({"mean", "sum", "none"})


def _validate_positive(name: str, value: float) -> None:
    if value <= 0:
        raise ValueError(f"{name} must be positive, {value} given")


def _validate_unit(name: str, value: float) -> None:
    if value < 0 or value > 1:
        raise ValueError(f"{name} must be between 0 and 1, {value} given")


@dataclass(frozen=True)
class LossConfig:
    """Quadruplet-loss hyperparameters (reference losses.py:9-69 defaults)."""

    # "gamma" | "d_regularized" | "triplet" ("triplet" is the plain
    # (anchor, pos, neg) margin loss — the ablation baseline; it ignores the
    # part-positive role entirely)
    kind: str = "gamma"
    gamma: float = DEFAULT_GAMMA
    margin_pos_neg: float = 1.0
    margin_pos_part: float = 0.5
    margin_part_neg: float = 0.5
    p: float = 2.0
    swap: bool = False
    reduction: str = "mean"
    # d-regularized variant only (reference losses.py:72-151).
    lmbd: float = 0.1
    # route the loss through the fused quadruplet kernel (ops/quadruplet.py:
    # K3 on CUDA, its plain version on the CPU; analytic backward) — the
    # p=2/no-swap gamma loss only
    use_fused_kernel: bool = False

    def __post_init__(self) -> None:
        if self.kind not in ("gamma", "d_regularized", "triplet"):
            raise ValueError(f"unknown loss kind: {self.kind}")
        if self.use_fused_kernel and (
                self.kind != "gamma" or self.p != 2.0 or self.swap):
            raise ValueError(
                "use_fused_kernel supports only the gamma loss with p=2 "
                "and swap=False (use the plain loss otherwise)")
        _validate_unit("gamma", self.gamma)
        _validate_positive("margin_pos_neg", self.margin_pos_neg)
        _validate_positive("margin_pos_part", self.margin_pos_part)
        _validate_positive("margin_part_neg", self.margin_part_neg)
        _validate_positive("p", self.p)
        _validate_positive("lmbd", self.lmbd)
        if self.reduction not in REDUCTIONS:
            raise ValueError(
                f"reduction must be one of {sorted(REDUCTIONS)}, "
                f"{self.reduction} given"
            )


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
    # sequences per grid step of the TPU kernel. The CUDA kernels need no
    # batch blocking, but with dropout on it decides the mask bits: sequence
    # b draws from grid step b // fused_nb, row b % fused_nb (the TPU
    # kernel's `seed ^ (program_id * 0x9E3779B9)`), so the port keeps it to
    # give the JAX package's masks
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


@dataclass(frozen=True)
class DataConfig:
    """Quadruplet dataset + mining config (reference quadruplet_dataset.py)."""

    root: str = "data/cleaned/coco/train"
    n_chunks: int = 0  # 0 → discover from directory
    chunk_dim: int = CHUNK_DIM
    n_pos: int = 1
    n_part_pos: int = 1
    n_neg: int = 1
    cache_size: int = 30
    # negative mining (reference quadruplet_dataset.py:16-21,185-270)
    hard_contrastive_mode: int = -1  # 1=train HCS, 0=test HCS, -1=random
    neg_sim_threshold: float = NEGATIVE_SIM_THRESHOLD
    neg_candidate_factor: int = 5
    neg_max_attempts: int = 3
    # device-side mining
    mining_refresh_steps: int = 500
    batch_size: int = 32
    max_seq_length: int = 128
    seed: int = RANDOM_SEED


@dataclass(frozen=True)
class TrainConfig:
    """Training defaults mirroring reference training/main.py:221-239."""

    batch_size: int = 32
    epochs: int = 10
    learning_rate: float = 2e-5
    weight_decay: float = 0.01
    scheduler: str = "warmuplinear"
    warmup_steps: int = 10_000
    max_grad_norm: float = 1.0
    evaluation_steps: int = 500
    checkpoint_save_steps: int = 500
    checkpoint_save_total_limit: int = 2
    save_best_model: bool = True
    use_amp: bool = True  # bf16 compute
    gradient_accumulation_steps: int = 1
    early_stopping_patience: int = 5
    early_stopping_delta: float = 0.0
    early_stopping_mode: str = "max"
    seed: int = RANDOM_SEED
    experiment_dir: str = "trained/exp"
    manual_notes: str = ""


def _to_jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {k: _to_jsonable(v) for k, v in dataclasses.asdict(obj).items()}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    return obj


def config_to_dict(cfg: Any) -> Dict[str, Any]:
    return _to_jsonable(cfg)


def save_config(cfg: Any, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(config_to_dict(cfg), f, indent=2, sort_keys=True)
