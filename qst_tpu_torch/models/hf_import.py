"""Carry weights into the port — counterpart of ``qst_tpu/models/hf_export.py``
(Flax params → HF names) and ``qst_tpu/models/hf_import.py`` (checkpoint
files).

- ``state_dict_from_flax_params(params, cfg)`` takes the JAX package's param
  tree (nested mappings of arrays; only ``np.asarray`` is called on the
  leaves) and returns the port's state dict, with the key names and
  transposes of ``export_bert_state_dict`` (``hf_export.py:23-66``).
- ``load_torch_state_dict(path)`` loads a ``pytorch_model.bin``-style file
  and keeps the ``BertModel`` trunk keys the port's modules hold.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from qst_tpu_torch.core.config import EncoderConfig


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def state_dict_from_flax_params(params: Mapping[str, Any],
                                cfg: EncoderConfig) -> Dict[str, torch.Tensor]:
    """Flax ``SentenceEncoderModule``/``BertEncoder`` params → the port's
    (HF ``BertModel``) state dict, float32 on the CPU."""
    if cfg.arch != "bert":
        raise NotImplementedError(f"arch={cfg.arch!r} is not ported (bert only)")
    p = params["encoder"] if "encoder" in params else params
    H = cfg.hidden_size
    emb = p["embeddings"]
    sd: Dict[str, torch.Tensor] = {
        "embeddings.word_embeddings.weight": _t(emb["word_embeddings"]["embedding"]),
        "embeddings.position_embeddings.weight": _t(emb["position_embeddings"]["embedding"]),
        "embeddings.token_type_embeddings.weight": _t(emb["token_type_embeddings"]["embedding"]),
        "embeddings.LayerNorm.weight": _t(emb["layer_norm"]["scale"]),
        "embeddings.LayerNorm.bias": _t(emb["layer_norm"]["bias"]),
    }
    for i in range(cfg.num_layers):
        layer = p[f"layer_{i}"]
        out = f"encoder.layer.{i}"
        attn = layer["attention"]
        for name in ("query", "key", "value"):
            sd[f"{out}.attention.self.{name}.weight"] = _t(
                np.asarray(attn[name]["kernel"]).reshape(H, H).T)
            sd[f"{out}.attention.self.{name}.bias"] = _t(
                np.asarray(attn[name]["bias"]).reshape(H))
        sd[f"{out}.attention.output.dense.weight"] = _t(
            np.asarray(attn["output_dense"]["kernel"]).reshape(H, H).T)
        sd[f"{out}.attention.output.dense.bias"] = _t(attn["output_dense"]["bias"])
        sd[f"{out}.attention.output.LayerNorm.weight"] = _t(layer["attention_layer_norm"]["scale"])
        sd[f"{out}.attention.output.LayerNorm.bias"] = _t(layer["attention_layer_norm"]["bias"])
        sd[f"{out}.intermediate.dense.weight"] = _t(np.asarray(layer["intermediate"]["kernel"]).T)
        sd[f"{out}.intermediate.dense.bias"] = _t(layer["intermediate"]["bias"])
        sd[f"{out}.output.dense.weight"] = _t(np.asarray(layer["output"]["kernel"]).T)
        sd[f"{out}.output.dense.bias"] = _t(layer["output"]["bias"])
        sd[f"{out}.output.LayerNorm.weight"] = _t(layer["output_layer_norm"]["scale"])
        sd[f"{out}.output.LayerNorm.bias"] = _t(layer["output_layer_norm"]["bias"])
    return sd


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Load a torch checkpoint file (e.g. ``pytorch_model.bin``) as the
    port's state dict: a ``bert.`` prefix is stripped, and the pooler and
    the ``position_ids``/``token_type_ids`` buffers are dropped."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    out: Dict[str, torch.Tensor] = {}
    for key, value in sd.items():
        key = key.removeprefix("bert.")
        if key.startswith("pooler.") or key in ("embeddings.position_ids",
                                                  "embeddings.token_type_ids"):
            continue
        out[key] = value.float()
    return out
