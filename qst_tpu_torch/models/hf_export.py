"""Write the port's weights as HF / sentence-transformers files — counterpart
of ``qst_tpu/models/hf_export.py`` (``export_state_dict``, :111, and
``save_torch_state_dict``, :119).

The port's state dict already carries HF ``BertModel`` / ``MPNetModel``
names, so the export is a copy into float32 numpy arrays (no pooler).
``save_checkpoint_dir`` writes a whole directory — ``config.json``, the
weights as ``model.safetensors`` or ``pytorch_model.bin``, ``vocab.txt``,
``sentence_bert_config.json`` and ``1_Pooling/config.json`` — that
``models/hf_import.load_hf_checkpoint_dir`` and the JAX package's loader
read.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from qst_tpu_torch.core.config import EncoderConfig
from qst_tpu_torch.models.hf_import import write_safetensors


def export_state_dict(state_dict: Mapping[str, torch.Tensor],
                      cfg: EncoderConfig) -> Dict[str, np.ndarray]:
    """The port's state dict → an HF ``BertModel`` / ``MPNetModel`` state
    dict of float32 numpy arrays (no pooler)."""
    if cfg.arch not in ("bert", "mpnet"):
        raise NotImplementedError(f"arch={cfg.arch!r} is not ported (bert and mpnet are)")
    return {k: v.detach().float().cpu().numpy().copy() for k, v in state_dict.items()}


def save_torch_state_dict(state_dict: Mapping[str, torch.Tensor], cfg: EncoderConfig,
                          path: str) -> None:
    """Write a ``pytorch_model.bin`` loadable by transformers."""
    torch.save({k: torch.from_numpy(v) for k, v in export_state_dict(state_dict, cfg).items()},
               path)


def hf_config(cfg: EncoderConfig) -> dict:
    """The ``config.json`` of an HF ``BertModel`` / ``MPNetModel`` with cfg's widths."""
    out = {
        "architectures": ["MPNetModel" if cfg.arch == "mpnet" else "BertModel"],
        "model_type": cfg.arch,
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "intermediate_size": cfg.intermediate_size,
        "max_position_embeddings": cfg.max_position_embeddings,
        "layer_norm_eps": cfg.layer_norm_eps,
        "pad_token_id": cfg.pad_token_id,
        "hidden_act": "gelu",
        "hidden_dropout_prob": cfg.hidden_dropout,
        "attention_probs_dropout_prob": cfg.attention_dropout,
    }
    if cfg.arch == "bert":
        out["type_vocab_size"] = cfg.type_vocab_size
    else:
        out["relative_attention_num_buckets"] = 32
    return out


def save_checkpoint_dir(state_dict: Mapping[str, torch.Tensor], cfg: EncoderConfig,
                        ckpt_dir: str, vocab: Optional[Sequence[str]] = None,
                        weights: str = "model.safetensors") -> str:
    """Write a sentence-transformers-style directory for ``state_dict``:
    ``config.json``, ``weights`` (``model.safetensors`` or
    ``pytorch_model.bin``), ``vocab.txt`` when ``vocab`` is given (one
    token a line), ``sentence_bert_config.json`` (cfg.max_seq_length) and
    ``1_Pooling/config.json`` (cfg.pooling). → ``ckpt_dir``."""
    if weights not in ("model.safetensors", "pytorch_model.bin"):
        raise ValueError(f"weights must be model.safetensors or pytorch_model.bin, got {weights}")
    os.makedirs(os.path.join(ckpt_dir, "1_Pooling"), exist_ok=True)
    with open(os.path.join(ckpt_dir, "config.json"), "w") as f:
        json.dump(hf_config(cfg), f, indent=2)
    path = os.path.join(ckpt_dir, weights)
    if weights == "model.safetensors":
        write_safetensors(export_state_dict(state_dict, cfg), path)
    else:
        save_torch_state_dict(state_dict, cfg, path)
    if vocab is not None:
        with open(os.path.join(ckpt_dir, "vocab.txt"), "w", encoding="utf-8") as f:
            f.write("\n".join(vocab) + "\n")
    with open(os.path.join(ckpt_dir, "sentence_bert_config.json"), "w") as f:
        json.dump({"max_seq_length": cfg.max_seq_length, "do_lower_case": False}, f)
    with open(os.path.join(ckpt_dir, "1_Pooling", "config.json"), "w") as f:
        json.dump({"word_embedding_dimension": cfg.hidden_size,
                   "pooling_mode_cls_token": cfg.pooling == "cls",
                   "pooling_mode_mean_tokens": cfg.pooling == "mean",
                   "pooling_mode_max_tokens": cfg.pooling == "max"}, f)
    return ckpt_dir
