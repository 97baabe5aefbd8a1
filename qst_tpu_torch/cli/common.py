"""Shared CLI plumbing: encoder presets, tokenizer loading, experiment
loading, provenance dumps — counterpart of ``qst_tpu/cli/common.py``.

All boolean flags use ``BooleanOptionalAction``. Every entry point takes
``--device`` (``add_device_flag``): the GPU unless the caller names another.
``--hf_checkpoint_dir`` (``add_hf_checkpoint_dir_flag``) loads a local
sentence-transformers directory through ``resolve_hf_checkpoint_dir``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, Optional

from qst_tpu_torch.core.config import EncoderConfig

ENCODER_PRESETS = {
    "tiny": EncoderConfig.tiny,
    "minilm-l6": EncoderConfig.minilm_l6,
    "mpnet-base": EncoderConfig.mpnet_base,
    "roberta-large": EncoderConfig.roberta_large,
}


def encoder_from_args(preset: str, max_seq_length: Optional[int] = None,
                      dtype: Optional[str] = None,
                      use_fused_layer: Optional[bool] = None) -> EncoderConfig:
    if preset not in ENCODER_PRESETS:
        raise ValueError(
            f"unknown encoder preset {preset!r}; choices: "
            f"{sorted(ENCODER_PRESETS)}")
    overrides: Dict[str, Any] = {}
    if max_seq_length is not None:
        overrides["max_seq_length"] = max_seq_length
    if dtype is not None:
        overrides["dtype"] = dtype
    if use_fused_layer is not None:
        overrides["use_fused_layer"] = use_fused_layer
    return ENCODER_PRESETS[preset](**overrides)


def tokenizer_from_args(vocab_path: Optional[str], vocab_size: int):
    from qst_tpu_torch.models.tokenizer import load_tokenizer

    return load_tokenizer(vocab_path or "", vocab_size=vocab_size)


def dump_args(args: argparse.Namespace, out_dir: str,
              manual_notes: str = "") -> str:
    """Persist the invocation next to its outputs."""
    os.makedirs(out_dir, exist_ok=True)
    payload = {**vars(args), "manual_notes": manual_notes}
    path = os.path.join(out_dir, "command_line_args.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True, default=str)
    return path


def load_best_params(experiment_dir: str):
    """Load the best-model state dict saved by a training run (on the CPU;
    the caller moves it to its device)."""
    from qst_tpu_torch.train.checkpoints import CheckpointManager

    mgr = CheckpointManager(os.path.join(experiment_dir, "checkpoints"),
                            save_steps=0, save_best=True)
    params = mgr.restore_best_params()
    mgr.close()
    if params is None:
        raise FileNotFoundError(
            f"no best checkpoint under {experiment_dir}/checkpoints/best")
    return params


def add_bool_flag(parser: argparse.ArgumentParser, name: str, default: bool,
                  help: str = "") -> None:
    parser.add_argument(f"--{name}", action=argparse.BooleanOptionalAction,
                        default=default, help=help)


def add_device_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--device", default=None,
        help="torch device to run on (default: the GPU; the command fails "
             "without one unless --device cpu is given)")


HF_CHECKPOINT_DIR_ENV = "QST_HF_CHECKPOINT_DIR"


def add_hf_checkpoint_dir_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--hf_checkpoint_dir",
        default=os.environ.get(HF_CHECKPOINT_DIR_ENV),
        help="local sentence-transformers/HF checkpoint directory (BERT or MPNet, "
             "e.g. a clone of all-MiniLM-L6-v2 or all-mpnet-base-v2); defaults to $"
             + HF_CHECKPOINT_DIR_ENV + ". Provides architecture config, weights and "
             "vocab in one shot")


def resolve_hf_checkpoint_dir(args: argparse.Namespace,
                              max_seq_length: Optional[int] = None,
                              dtype: Optional[str] = None):
    """If ``--hf_checkpoint_dir`` / $QST_HF_CHECKPOINT_DIR is set, load it →
    (EncoderConfig, state dict on the CPU, tokenizer); else None. Explicit
    ``--vocab_path``, ``--max_seq_length`` and ``dtype`` (``--use_amp``
    off: float32) still win over the checkpoint's own
    (``qst_tpu/cli/common.py:100-121``)."""
    ckpt_dir = getattr(args, "hf_checkpoint_dir", None)
    if not ckpt_dir:
        return None
    import dataclasses

    from qst_tpu_torch.models.hf_import import load_hf_checkpoint_dir

    cfg, params, vocab_path = load_hf_checkpoint_dir(ckpt_dir)
    overrides: Dict[str, Any] = {}
    if max_seq_length is not None:
        overrides["max_seq_length"] = max_seq_length
    if dtype is not None:
        overrides["dtype"] = dtype
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    explicit_vocab = getattr(args, "vocab_path", None)
    tokenizer = tokenizer_from_args(explicit_vocab or vocab_path, cfg.vocab_size)
    return cfg, params, tokenizer


def primary_first(fn):
    """``fn()`` on process 0 of a group first, then, after a barrier, on the
    others: a cache file that ``fn`` writes (the IR evaluation set's) is
    whole before they read it. One process: ``fn()``."""
    from qst_tpu_torch.core.meshes import barrier, is_primary

    out = fn() if is_primary() else None
    barrier()
    return out if is_primary() else fn()
