"""Carry weights into the port — counterpart of ``qst_tpu/models/hf_export.py``
(Flax params → HF names) and ``qst_tpu/models/hf_import.py`` (checkpoint
files and directories).

- ``state_dict_from_flax_params(params, cfg)`` takes the JAX package's param
  tree (nested mappings of arrays; only ``np.asarray`` is called on the
  leaves) and returns the port's state dict, with the key names and
  transposes of ``export_bert_state_dict`` / ``export_mpnet_state_dict``
  (``hf_export.py:23-108``).
- ``load_torch_state_dict(path)`` loads a ``pytorch_model.bin`` or a
  ``model.safetensors`` file (read by ``read_safetensors``, the port's own
  reader: no ``safetensors`` package is needed) and keeps the BERT or MPNet
  trunk keys the port's modules hold.
- ``load_hf_checkpoint_dir(dir)`` loads a local sentence-transformers / HF
  directory into (EncoderConfig, state dict, vocab path), as
  ``qst_tpu/models/hf_import.py:422`` does; RoBERTa raises.
"""

from __future__ import annotations

import glob
import json
import os
import struct
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from qst_tpu_torch.core.config import EncoderConfig


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def state_dict_from_flax_params(params: Mapping[str, Any],
                                cfg: EncoderConfig) -> Dict[str, torch.Tensor]:
    """Flax ``SentenceEncoderModule`` / ``BertEncoder`` / ``MPNetEncoder``
    params → the port's (HF ``BertModel`` / ``MPNetModel``) state dict,
    float32 on the CPU."""
    p = params["encoder"] if "encoder" in params else params
    if cfg.arch == "mpnet":
        return _mpnet_state_dict(p, cfg)
    if cfg.arch != "bert":
        raise NotImplementedError(f"arch={cfg.arch!r} is not ported (bert and mpnet are)")
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


def _mpnet_state_dict(p: Mapping[str, Any], cfg: EncoderConfig) -> Dict[str, torch.Tensor]:
    """``export_mpnet_state_dict`` (``hf_export.py:69``) into torch tensors."""
    H = cfg.hidden_size
    sd: Dict[str, torch.Tensor] = {
        "embeddings.word_embeddings.weight": _t(p["word_embeddings"]["embedding"]),
        "embeddings.position_embeddings.weight": _t(p["position_embeddings"]["embedding"]),
        "embeddings.LayerNorm.weight": _t(p["embed_layer_norm"]["scale"]),
        "embeddings.LayerNorm.bias": _t(p["embed_layer_norm"]["bias"]),
        "encoder.relative_attention_bias.weight": _t(p["relative_attention_bias"]["embedding"]),
    }
    for i in range(cfg.num_layers):
        layer = p[f"layer_{i}"]
        out = f"encoder.layer.{i}"
        attn = layer["attention"]
        for name in ("q", "k", "v", "o"):
            sd[f"{out}.attention.attn.{name}.weight"] = _t(
                np.asarray(attn[name]["kernel"]).reshape(H, H).T)
            sd[f"{out}.attention.attn.{name}.bias"] = _t(np.asarray(attn[name]["bias"]).reshape(H))
        sd[f"{out}.attention.LayerNorm.weight"] = _t(layer["attention_layer_norm"]["scale"])
        sd[f"{out}.attention.LayerNorm.bias"] = _t(layer["attention_layer_norm"]["bias"])
        sd[f"{out}.intermediate.dense.weight"] = _t(np.asarray(layer["intermediate"]["kernel"]).T)
        sd[f"{out}.intermediate.dense.bias"] = _t(layer["intermediate"]["bias"])
        sd[f"{out}.output.dense.weight"] = _t(np.asarray(layer["output"]["kernel"]).T)
        sd[f"{out}.output.dense.bias"] = _t(layer["output"]["bias"])
        sd[f"{out}.output.LayerNorm.weight"] = _t(layer["output_layer_norm"]["scale"])
        sd[f"{out}.output.LayerNorm.bias"] = _t(layer["output_layer_norm"]["bias"])
    return sd


# safetensors' dtype names → numpy little-endian types (BF16 is widened by hand)
_ST_DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8", "I32": "<i4",
              "I16": "<i2", "I8": "i1", "U8": "u1", "BOOL": "?"}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """A ``.safetensors`` file as numpy arrays: an 8-byte little-endian
    header length, a JSON header of {name: {dtype, shape, data_offsets}}
    (offsets into the buffer after the header; ``__metadata__`` skipped),
    then the raw little-endian buffers. BF16 becomes float32 exactly."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        buf = f.read()
    out: Dict[str, np.ndarray] = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        lo, hi = meta["data_offsets"]
        raw, dt, shape = buf[lo:hi], meta["dtype"], tuple(meta["shape"])
        if dt == "BF16":
            bits = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
            arr = bits.view(np.float32)
        elif dt in _ST_DTYPES:
            arr = np.frombuffer(raw, dtype=_ST_DTYPES[dt])
        else:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {dt}")
        out[name] = arr.reshape(shape).copy()
    return out


def write_safetensors(tensors: Mapping[str, np.ndarray], path: str) -> None:
    """Write float32 arrays as a ``.safetensors`` file (the layout
    ``read_safetensors`` reads), names in sorted order."""
    header, chunks, offset = {}, [], 0
    for name in sorted(tensors):
        a = np.ascontiguousarray(tensors[name], dtype="<f4")
        header[name] = {"dtype": "F32", "shape": list(a.shape),
                        "data_offsets": [offset, offset + a.nbytes]}
        chunks.append(a.tobytes())
        offset += a.nbytes
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for c in chunks:
            f.write(c)


# prefixes of trunk keys in HF / sentence-transformers files (the source's
# _PREFIXES, with MPNet's)
_PREFIXES = ("bert.", "mpnet.", "roberta.", "0.auto_model.", "auto_model.")


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Load a checkpoint file (``pytorch_model.bin`` or ``model.safetensors``)
    as the port's state dict, float32 on the CPU: a trunk prefix (``bert.``,
    ``mpnet.``, ``0.auto_model.``, ...) is stripped from each key, and the
    pooler and the ``position_ids``/``token_type_ids`` buffers are dropped."""
    if path.endswith(".safetensors"):
        sd = {k: torch.from_numpy(v) for k, v in read_safetensors(path).items()}
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    out: Dict[str, torch.Tensor] = {}
    for key, value in sd.items():
        for prefix in _PREFIXES:
            if key.startswith(prefix):
                key = key[len(prefix):]
                break
        if key.startswith("pooler.") or key in ("embeddings.position_ids",
                                                  "embeddings.token_type_ids"):
            continue
        out[key] = value.float()
    return out


# ---------------------------------------------------------------------------
# Checkpoint directories (qst_tpu/models/hf_import.py:338-468)
# ---------------------------------------------------------------------------
def _resolve_checkpoint_files(ckpt_dir: str):
    """→ (weights path, parsed trunk config.json, finder fn). Weights may
    live at the root or under a ``0_*``-style module subdirectory; the
    trunk's config.json sits next to the weights (never 1_Pooling's)."""
    if not os.path.isdir(ckpt_dir):
        raise FileNotFoundError(f"checkpoint dir not found: {ckpt_dir}")

    def find(name: str) -> Optional[str]:
        cands = [os.path.join(ckpt_dir, name)]
        cands += sorted(glob.glob(os.path.join(ckpt_dir, "*", name)))
        for c in cands:
            if os.path.isfile(c):
                return c
        return None

    weights = find("model.safetensors") or find("pytorch_model.bin")
    if weights is None:
        raise FileNotFoundError(f"no model.safetensors / pytorch_model.bin under {ckpt_dir}")
    cfg_path = os.path.join(os.path.dirname(weights), "config.json")
    if not os.path.isfile(cfg_path):
        raise FileNotFoundError(f"no config.json next to {weights}")
    with open(cfg_path) as f:
        hf_cfg = json.load(f)
    return weights, hf_cfg, find


def _encoder_cfg_kwargs(ckpt_dir: str, hf_cfg: dict) -> dict:
    model_type = hf_cfg.get("model_type", "bert")
    if model_type == "roberta":
        raise NotImplementedError(
            f"{ckpt_dir}: model_type 'roberta' is not ported to qst_tpu_torch: it needs the "
            "byte-level BPE tokenizer and the RoBERTa trunk (ROADMAP A8, A9)")
    if model_type not in ("bert", "mpnet"):
        raise ValueError(f"unsupported model_type {model_type!r} (bert and mpnet trunks load)")
    kw = dict(
        name=os.path.basename(os.path.normpath(ckpt_dir)),
        arch=model_type,
        vocab_size=int(hf_cfg["vocab_size"]),
        hidden_size=int(hf_cfg["hidden_size"]),
        num_layers=int(hf_cfg["num_hidden_layers"]),
        num_heads=int(hf_cfg["num_attention_heads"]),
        intermediate_size=int(hf_cfg["intermediate_size"]),
        max_position_embeddings=int(hf_cfg["max_position_embeddings"]),
        layer_norm_eps=float(hf_cfg.get("layer_norm_eps", 1e-12)),
        pad_token_id=int(hf_cfg.get("pad_token_id", 0)),
    )
    if model_type == "bert":
        kw["type_vocab_size"] = int(hf_cfg.get("type_vocab_size", 2))
    return kw


def load_hf_checkpoint_dir(ckpt_dir: str
                           ) -> Tuple[EncoderConfig, Dict[str, torch.Tensor], Optional[str]]:
    """Load a local sentence-transformers / HF checkpoint directory (a clone
    of ``all-MiniLM-L6-v2`` or ``all-mpnet-base-v2``, say) into
    (EncoderConfig, the port's state dict on the CPU, vocab path or None).

    Resolution (no network), as the source resolves it:
    - weights: ``model.safetensors`` or ``pytorch_model.bin`` at the root or
      under a ``0_*``-style module subdirectory;
    - architecture: ``config.json`` (model_type bert or mpnet; roberta
      raises ``NotImplementedError``);
    - ``sentence_bert_config.json`` → max_seq_length when present;
    - ``1_Pooling/config.json`` → pooling mode when present;
    - ``vocab.txt`` (WordPiece) → the tokenizer."""
    weights, hf_cfg, find = _resolve_checkpoint_files(ckpt_dir)
    kw = _encoder_cfg_kwargs(ckpt_dir, hf_cfg)
    sbert_cfg = find("sentence_bert_config.json")
    if sbert_cfg:
        with open(sbert_cfg) as f:
            kw["max_seq_length"] = int(json.load(f).get("max_seq_length", 128))
    pool_cfg = find(os.path.join("1_Pooling", "config.json")) or find("pooling_config.json")
    if pool_cfg:
        with open(pool_cfg) as f:
            pooling = json.load(f)
        if pooling.get("pooling_mode_cls_token"):
            kw["pooling"] = "cls"
        elif pooling.get("pooling_mode_max_tokens"):
            kw["pooling"] = "max"
        else:
            kw["pooling"] = "mean"
    cfg = EncoderConfig(**kw)
    return cfg, load_torch_state_dict(weights), find("vocab.txt")
