"""Core configuration, device meshes, RNG streams and telemetry
(counterpart of ``qst_tpu/core``)."""

from qst_tpu_torch.core.config import (
    LossConfig,
    EncoderConfig,
    DataConfig,
    TrainConfig,
    IREvalConfig,
    MeshConfig,
    ExperimentConfig,
    config_hash,
    save_config,
    load_config,
)
from qst_tpu_torch.core.meshes import make_mesh, dtype_policy, DTypePolicy
from qst_tpu_torch.core.rng import RngStream, seed_everything
from qst_tpu_torch.core.telemetry import CsvSink, JsonLogSink, StepTimer

__all__ = [
    "LossConfig",
    "EncoderConfig",
    "DataConfig",
    "TrainConfig",
    "IREvalConfig",
    "MeshConfig",
    "ExperimentConfig",
    "config_hash",
    "save_config",
    "load_config",
    "make_mesh",
    "dtype_policy",
    "DTypePolicy",
    "RngStream",
    "seed_everything",
    "CsvSink",
    "JsonLogSink",
    "StepTimer",
]
