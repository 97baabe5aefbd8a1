"""Carry weights into the port — counterpart of ``qst_tpu/models/hf_export.py``
(Flax params → HF names) and ``qst_tpu/models/hf_import.py`` (checkpoint
files and directories).

- ``state_dict_from_flax_params(params, cfg)`` takes the JAX package's param
  tree (nested mappings of arrays; only ``np.asarray`` is called on the
  leaves) and returns the port's state dict, with the key names and
  transposes of ``export_bert_state_dict`` / ``export_mpnet_state_dict``
  (``hf_export.py:23-108``; RoBERTa has BERT's), and the heads of a
  ``CrossEncoderModule`` or a ``BertMLMModule`` when the tree has them.
- ``load_torch_state_dict(path)`` loads a ``pytorch_model.bin`` or a
  ``model.safetensors`` file (read by ``read_safetensors``, the port's own
  reader: no ``safetensors`` package is needed) and keeps the BERT, RoBERTa
  or MPNet trunk keys the port's modules hold, and a classifier's.
- ``load_hf_checkpoint_dir(dir)`` loads a local sentence-transformers / HF
  directory into (EncoderConfig, state dict, vocab path), as
  ``qst_tpu/models/hf_import.py:422`` does; ``load_cross_encoder_dir(dir)``
  loads an HF ``*ForSequenceClassification`` directory (num_labels 1) into
  a ``CrossEncoderModule``'s (``:205``).
- ``import_bert_params(state_dict, cfg)`` and
  ``import_sentence_encoder_params(state_dict, cfg)`` are the JAX package's
  names (``qst_tpu/models/hf_import.py:43, :126``): an HF state dict → the
  state dict of the trunk that ``cfg`` builds, raising where a key of that
  trunk is missing or has another shape (``models/mpnet.py:import_mpnet_params``
  is MPNet's).
- ``load_marian_dir(dir)`` loads a local HF MarianMT directory into
  (Seq2SeqConfig, ``MarianModule`` state dict, generation defaults), as
  ``qst_tpu/models/hf_import.py:272`` does;
  ``marian_state_dict_from_flax_params(params, cfg)`` carries the JAX
  package's Marian tree over.
"""

from __future__ import annotations

import dataclasses
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
    """Flax ``SentenceEncoderModule`` / ``BertEncoder`` / ``MPNetEncoder`` /
    ``CrossEncoderModule`` / ``BertMLMModule`` params → the port's state
    dict (HF ``BertModel`` / ``MPNetModel`` trunk names, and the heads of
    ``models/cross_encoder.py`` and ``models/mlm.py``), float32 on the CPU.
    A tensor-parallel state gathered to arrays has the flat tree's layout
    and converts the same way. A pipeline tree ({"embeddings", "stages"},
    every stage leaf with leading (n_stages, layers a stage) axes,
    ``qst_tpu/parallel/pipeline.py``) becomes the stacked layout of
    ``parallel/pipeline.py:PipelineLayout``: ``embeddings.*`` and
    ``stages.{layer name}`` with the same two leading axes."""
    p = params["encoder"] if "encoder" in params else params
    if "stages" in p:
        return _pipeline_state_dict(p, cfg)
    if cfg.arch == "mpnet":
        sd = _mpnet_state_dict(p, cfg)
    elif cfg.arch in ("bert", "roberta"):
        sd = _bert_state_dict(p, cfg)
    else:
        raise ValueError(f"unknown arch {cfg.arch!r}")
    heads = (("head_dense", "classifier.dense"), ("out_proj", "classifier.out_proj"),
             ("classifier", "classifier"), ("transform", "transform"), ("decoder", "decoder"))
    for flax_name, name in heads:
        if flax_name in params:
            sd[f"{name}.weight"] = _t(np.asarray(params[flax_name]["kernel"]).T)
            sd[f"{name}.bias"] = _t(params[flax_name]["bias"])
    if "transform_layer_norm" in params:
        sd["transform_layer_norm.weight"] = _t(params["transform_layer_norm"]["scale"])
        sd["transform_layer_norm.bias"] = _t(params["transform_layer_norm"]["bias"])
    return sd


def _bert_state_dict(p: Mapping[str, Any], cfg: EncoderConfig) -> Dict[str, torch.Tensor]:
    """``export_bert_state_dict`` (``hf_export.py:23``) into torch tensors."""
    H = cfg.hidden_size
    sd = _bert_embeddings(p["embeddings"])
    for i in range(cfg.num_layers):
        sd.update({f"encoder.layer.{i}.{k}": v for k, v in _bert_layer(p[f"layer_{i}"], H).items()})
    return sd


def _bert_embeddings(emb: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    return {
        "embeddings.word_embeddings.weight": _t(emb["word_embeddings"]["embedding"]),
        "embeddings.position_embeddings.weight": _t(emb["position_embeddings"]["embedding"]),
        "embeddings.token_type_embeddings.weight": _t(emb["token_type_embeddings"]["embedding"]),
        "embeddings.LayerNorm.weight": _t(emb["layer_norm"]["scale"]),
        "embeddings.LayerNorm.bias": _t(emb["layer_norm"]["bias"]),
    }


def _bert_layer(layer: Mapping[str, Any], H: int) -> Dict[str, torch.Tensor]:
    """One Flax ``BertLayer``'s params → its HF tensors, names relative to
    the layer."""
    sd: Dict[str, torch.Tensor] = {}
    attn = layer["attention"]
    for name in ("query", "key", "value"):
        sd[f"attention.self.{name}.weight"] = _t(np.asarray(attn[name]["kernel"]).reshape(H, H).T)
        sd[f"attention.self.{name}.bias"] = _t(np.asarray(attn[name]["bias"]).reshape(H))
    sd["attention.output.dense.weight"] = _t(
        np.asarray(attn["output_dense"]["kernel"]).reshape(H, H).T)
    sd["attention.output.dense.bias"] = _t(attn["output_dense"]["bias"])
    sd["attention.output.LayerNorm.weight"] = _t(layer["attention_layer_norm"]["scale"])
    sd["attention.output.LayerNorm.bias"] = _t(layer["attention_layer_norm"]["bias"])
    sd["intermediate.dense.weight"] = _t(np.asarray(layer["intermediate"]["kernel"]).T)
    sd["intermediate.dense.bias"] = _t(layer["intermediate"]["bias"])
    sd["output.dense.weight"] = _t(np.asarray(layer["output"]["kernel"]).T)
    sd["output.dense.bias"] = _t(layer["output"]["bias"])
    sd["output.LayerNorm.weight"] = _t(layer["output_layer_norm"]["scale"])
    sd["output.LayerNorm.bias"] = _t(layer["output_layer_norm"]["bias"])
    return sd


def _leaf_at(tree: Mapping[str, Any], s: int, slot: int) -> Dict[str, Any]:
    return {k: (_leaf_at(v, s, slot) if isinstance(v, Mapping) else np.asarray(v)[s, slot])
            for k, v in tree.items()}


def _pipeline_state_dict(p: Mapping[str, Any], cfg: EncoderConfig) -> Dict[str, torch.Tensor]:
    """The JAX pipeline tree → ``embeddings.*`` and the stacked
    ``stages.*`` (BERT: the JAX pipeline runs ``BertLayer``)."""
    sd = _bert_embeddings(p["embeddings"])
    leaf = p["stages"]
    while isinstance(leaf, Mapping):
        leaf = next(iter(leaf.values()))
    n_stages, per = np.asarray(leaf).shape[:2]
    slots = [[_bert_layer(_leaf_at(p["stages"], s, k), cfg.hidden_size) for k in range(per)]
             for s in range(n_stages)]
    for name in slots[0][0]:
        sd[f"stages.{name}"] = torch.stack([torch.stack([slots[s][k][name] for k in range(per)])
                                            for s in range(n_stages)])
    return sd


def flax_params_from_state_dict(sd: Mapping[str, torch.Tensor],
                                cfg: EncoderConfig) -> Dict[str, Any]:
    """The reverse of ``state_dict_from_flax_params`` for a BERT trunk: the
    port's state dict → the JAX package's ``{"encoder": ...}`` param tree
    of numpy arrays; a stacked pipeline state dict (``stages.*``) → the
    JAX pipeline's {"embeddings", "stages"} tree."""
    if cfg.arch not in ("bert", "roberta"):
        raise ValueError(f"flax_params_from_state_dict carries BERT trunks, {cfg.arch!r} given")
    H, nh = cfg.hidden_size, cfg.num_heads
    a = {k: v.detach().cpu().float().numpy() for k, v in sd.items()}

    def layer(get):
        t = lambda n: np.swapaxes(get(n + ".weight"), -1, -2)  # noqa: E731
        heads = lambda x: x.reshape(x.shape[:-2] + (H, nh, H // nh))  # noqa: E731
        qkv = {f: {"kernel": heads(t(f"attention.self.{n}")),
                   "bias": get(f"attention.self.{n}.bias").reshape(
                       get(f"attention.self.{n}.bias").shape[:-1] + (nh, H // nh))}
               for f, n in (("query", "query"), ("key", "key"), ("value", "value"))}
        wo = t("attention.output.dense")
        return {"attention": {**qkv, "output_dense": {
                    "kernel": wo.reshape(wo.shape[:-2] + (nh, H // nh, H)),
                    "bias": get("attention.output.dense.bias")}},
                "attention_layer_norm": {"scale": get("attention.output.LayerNorm.weight"),
                                         "bias": get("attention.output.LayerNorm.bias")},
                "intermediate": {"kernel": t("intermediate.dense"),
                                 "bias": get("intermediate.dense.bias")},
                "output": {"kernel": t("output.dense"), "bias": get("output.dense.bias")},
                "output_layer_norm": {"scale": get("output.LayerNorm.weight"),
                                      "bias": get("output.LayerNorm.bias")}}

    emb = {"word_embeddings": {"embedding": a["embeddings.word_embeddings.weight"]},
           "position_embeddings": {"embedding": a["embeddings.position_embeddings.weight"]},
           "token_type_embeddings": {"embedding": a["embeddings.token_type_embeddings.weight"]},
           "layer_norm": {"scale": a["embeddings.LayerNorm.weight"],
                          "bias": a["embeddings.LayerNorm.bias"]}}
    if any(k.startswith("stages.") for k in a):
        return {"embeddings": emb, "stages": layer(lambda n: a[f"stages.{n}"])}
    return {"encoder": {"embeddings": emb, **{
        f"layer_{i}": layer(lambda n, i=i: a[f"encoder.layer.{i}.{n}"])
        for i in range(cfg.num_layers)}}}


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
    ``roberta.``, ``mpnet.``, ``0.auto_model.``, ...) is stripped from each
    key, and the pooler and the ``position_ids``/``token_type_ids`` buffers
    are dropped. Keys without a prefix (a ``*ForSequenceClassification``
    file's ``classifier.*``) stay as they are."""
    if path.endswith(".safetensors"):
        sd = {k: torch.from_numpy(v) for k, v in read_safetensors(path).items()}
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    return import_state_dict(sd)


def import_state_dict(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """An HF state dict (tensors or arrays) → the port's names, float32 on
    the CPU (``load_torch_state_dict``'s rules)."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in sd.items():
        for prefix in _PREFIXES:
            if key.startswith(prefix):
                key = key[len(prefix):]
                break
        if key.startswith("pooler.") or key in ("embeddings.position_ids",
                                                  "embeddings.token_type_ids"):
            continue
        out[key] = torch.as_tensor(value).float()
    return out


def select_trunk(state_dict: Mapping[str, Any], cfg: EncoderConfig,
                 arch: str) -> Dict[str, torch.Tensor]:
    """The tensors of ``state_dict`` (HF or the port's names;
    ``import_state_dict``'s rules) that the ``arch`` trunk (``bert``,
    ``roberta`` or ``mpnet``) at cfg's widths holds, float32. Raises
    KeyError when the trunk lacks one of them — an MPNet state dict given
    for BERT, or fewer layers than ``cfg.num_layers`` — and ValueError when
    one has another shape than cfg gives it. Keys beyond the trunk (the
    pooler, heads, layers past ``cfg.num_layers``) are left out, as the
    source's importers leave them."""
    from qst_tpu_torch.models.sentence_encoder import TRUNKS

    sd = import_state_dict(state_dict)
    if "embeddings.word_embeddings.weight" not in sd:
        raise KeyError("state dict does not look like a BERT trunk: no "
                       "embeddings.word_embeddings.weight under known prefixes")
    with torch.device("meta"):        # names and shapes, no memory
        trunk = TRUNKS[arch](dataclasses.replace(cfg, arch=arch))
    want = {k: tuple(v.shape) for k, v in trunk.state_dict().items()}
    missing = [k for k in want if k not in sd]
    if missing:
        raise KeyError(f"{len(missing)} tensors of a {arch} trunk of {cfg.num_layers} layers "
                       f"are not in the state dict: {missing[:4]}")
    wrong = [(k, tuple(sd[k].shape), s) for k, s in want.items() if tuple(sd[k].shape) != s]
    if wrong:
        raise ValueError(f"shapes differ from the config's (name, given, wanted): {wrong[:4]}")
    return {k: sd[k] for k in want}


def import_bert_params(state_dict: Mapping[str, Any],
                       cfg: EncoderConfig) -> Dict[str, torch.Tensor]:
    """An HF ``BertModel`` / ``RobertaModel`` state dict (tensors or arrays,
    with or without a ``bert.`` / ``roberta.`` / sentence-transformers
    prefix) → the state dict of ``BertEncoder(cfg)``, which is also
    ``SentenceEncoderModule(cfg)``'s (``qst_tpu/models/hf_import.py:43``)."""
    return select_trunk(state_dict, cfg, "roberta" if cfg.arch == "roberta" else "bert")


def import_sentence_encoder_params(state_dict: Mapping[str, Any],
                                   cfg: EncoderConfig) -> Dict[str, torch.Tensor]:
    """An HF state dict → the state dict of ``SentenceEncoderModule(cfg)``,
    dispatching on ``cfg.arch`` (``qst_tpu/models/hf_import.py:126``)."""
    if cfg.arch == "mpnet":
        from qst_tpu_torch.models.mpnet import import_mpnet_params

        return import_mpnet_params(state_dict, cfg)
    return import_bert_params(state_dict, cfg)


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
    if model_type not in ("bert", "mpnet", "roberta"):
        raise ValueError(f"unsupported model_type {model_type!r} "
                         "(bert, roberta and mpnet trunks are supported)")
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
    elif model_type == "roberta":
        kw["type_vocab_size"] = int(hf_cfg.get("type_vocab_size", 1))
    return kw


def _vocab_path(find) -> Optional[str]:
    """``vocab.txt`` (WordPiece), else ``vocab.json`` (byte-level BPE, with
    ``merges.txt`` beside it): ``load_tokenizer`` dispatches on the suffix."""
    return find("vocab.txt") or find("vocab.json")


def import_cross_encoder_params(state_dict: Mapping[str, Any],
                                cfg: EncoderConfig) -> Dict[str, torch.Tensor]:
    """An HF ``*ForSequenceClassification`` state dict (num_labels 1) → a
    ``CrossEncoderModule`` state dict: the trunk with its prefix stripped and
    the architecture's head (RoBERTa: ``classifier.dense`` +
    ``classifier.out_proj``; BERT: ``classifier``), as
    ``qst_tpu/models/hf_import.py:99-125`` maps it."""
    sd = import_state_dict(state_dict)
    heads = (("classifier.dense", "classifier.out_proj") if cfg.arch == "roberta"
             else ("classifier",))
    keep = tuple(f"{h}.{w}" for h in heads for w in ("weight", "bias"))
    missing = [k for k in keep if k not in sd]
    if missing:
        raise KeyError(f"no {missing} in the state dict: not a {cfg.arch} "
                       "*ForSequenceClassification checkpoint")
    return {k: v for k, v in sd.items() if not k.startswith("classifier") or k in keep}


def load_cross_encoder_dir(ckpt_dir: str, max_seq_length: Optional[int] = None
                           ) -> Tuple[EncoderConfig, Dict[str, torch.Tensor], Optional[str]]:
    """Load a local HF ``*ForSequenceClassification`` checkpoint directory
    (num_labels 1) — the layout of sentence-transformers CrossEncoder
    checkpoints such as the reference's ``cross-encoder/stsb-roberta-large``
    — into (EncoderConfig, ``CrossEncoderModule`` state dict on the CPU,
    vocab path or None)."""
    weights, hf_cfg, find = _resolve_checkpoint_files(ckpt_dir)
    kw = _encoder_cfg_kwargs(ckpt_dir, hf_cfg)
    if max_seq_length is not None:
        kw["max_seq_length"] = int(max_seq_length)
    cfg = EncoderConfig(**kw)
    sd = import_cross_encoder_params(load_torch_state_dict(weights), cfg)
    return cfg, sd, _vocab_path(find)


def load_hf_checkpoint_dir(ckpt_dir: str
                           ) -> Tuple[EncoderConfig, Dict[str, torch.Tensor], Optional[str]]:
    """Load a local sentence-transformers / HF checkpoint directory (a clone
    of ``all-MiniLM-L6-v2`` or ``all-mpnet-base-v2``, say) into
    (EncoderConfig, the port's state dict on the CPU, vocab path or None).

    Resolution (no network), as the source resolves it:
    - weights: ``model.safetensors`` or ``pytorch_model.bin`` at the root or
      under a ``0_*``-style module subdirectory;
    - architecture: ``config.json`` (model_type bert, roberta or mpnet);
    - ``sentence_bert_config.json`` → max_seq_length when present;
    - ``1_Pooling/config.json`` → pooling mode when present;
    - ``vocab.txt`` (WordPiece) or ``vocab.json`` (byte-level BPE) → the
      tokenizer."""
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
    return cfg, load_torch_state_dict(weights), _vocab_path(find)


# ---------------------------------------------------------------------------
# MarianMT (qst_tpu/models/hf_import.py:272-345)
# ---------------------------------------------------------------------------
def marian_state_dict_from_flax_params(params: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """The JAX package's ``MarianModule`` params (``init_seq2seq`` /
    ``import_marian_params``; only ``np.asarray`` is called on the leaves)
    → the port's ``MarianModule`` state dict, float32 on the CPU."""
    def dense(p, name):
        return {f"{name}.weight": _t(np.asarray(p["kernel"]).T), f"{name}.bias": _t(p["bias"])}

    def ln(p, name):
        return {f"{name}.weight": _t(p["scale"]), f"{name}.bias": _t(p["bias"])}

    def layer(p, name, attns):
        out = {}
        for a in attns:
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                out.update(dense(p[a][proj], f"{name}.{a}.{proj}"))
            out.update(ln(p[f"{a}_layer_norm"], f"{name}.{a}_layer_norm"))
        for n in ("fc1", "fc2"):
            out.update(dense(p[n], f"{name}.{n}"))
        out.update(ln(p["final_layer_norm"], f"{name}.final_layer_norm"))
        return out

    positions = _t(params["embed_positions"])
    sd = {"model.shared.weight": _t(params["shared"]["embedding"]),
          "model.encoder.embed_positions.weight": positions,
          "model.decoder.embed_positions.weight": positions.clone(),
          "final_logits_bias": _t(params["final_logits_bias"]).reshape(1, -1)}
    for i in range(cfg.encoder_layers):
        sd.update(layer(params[f"encoder_layer_{i}"], f"model.encoder.layers.{i}",
                        ("self_attn",)))
    for i in range(cfg.decoder_layers):
        sd.update(layer(params[f"decoder_layer_{i}"], f"model.decoder.layers.{i}",
                        ("self_attn", "encoder_attn")))
    return sd


def load_marian_dir(ckpt_dir: str):
    """Load a local HF MarianMT checkpoint DIRECTORY (the layout of
    ``Helsinki-NLP/opus-mt-en-fr`` clones — the models the reference's
    backtranslation downloads at reference dataset/backtranslation.py:8-49)
    into ``(Seq2SeqConfig, the port's state dict on the CPU, generation
    defaults dict)``.

    The state dict loads into :class:`qst_tpu_torch.models.seq2seq.MarianModule`;
    the generation defaults capture the checkpoint's
    ``generation_config.json`` / ``config.json`` decode settings
    (``num_beams``, ``max_length``, ``length_penalty``, pad suppression via
    single-token ``bad_words_ids``, ``forced_eos_token_id``) as the source
    reads them.
    """
    from qst_tpu_torch.models.seq2seq import Seq2SeqConfig, import_marian_params

    weights, hf_cfg, find = _resolve_checkpoint_files(ckpt_dir)
    if hf_cfg.get("model_type", "marian") != "marian":
        raise ValueError(
            f"{ckpt_dir}: model_type {hf_cfg.get('model_type')!r} is not a "
            "MarianMT checkpoint")
    cfg = Seq2SeqConfig(
        vocab_size=int(hf_cfg["vocab_size"]),
        d_model=int(hf_cfg["d_model"]),
        encoder_layers=int(hf_cfg["encoder_layers"]),
        decoder_layers=int(hf_cfg["decoder_layers"]),
        num_heads=int(hf_cfg["encoder_attention_heads"]),
        ffn_dim=int(hf_cfg["encoder_ffn_dim"]),
        max_position_embeddings=int(hf_cfg["max_position_embeddings"]),
        pad_token_id=int(hf_cfg["pad_token_id"]),
        eos_token_id=int(hf_cfg["eos_token_id"]),
        decoder_start_token_id=int(hf_cfg["decoder_start_token_id"]),
        scale_embedding=bool(hf_cfg.get("scale_embedding", True)),
        activation=hf_cfg.get("activation_function", "swish"),
    )
    sd = import_marian_params(load_torch_state_dict(weights), cfg)

    # generation defaults: generation_config.json overrides config.json
    gen = dict(hf_cfg)
    gen_path = find("generation_config.json")
    if gen_path:
        with open(gen_path) as f:
            gen.update(json.load(f))
    suppress = []
    dropped = []
    for word in gen.get("bad_words_ids") or []:
        if len(word) == 1:  # Marian ships [[pad_token_id]]
            suppress.append(int(word[0]))
        else:
            dropped.append(word)
    if dropped:
        import warnings

        warnings.warn(
            f"{ckpt_dir}: {len(dropped)} multi-token bad_words_ids entries "
            f"(e.g. {dropped[0]}) are not supported by the on-device decode "
            "and were DROPPED — generation may differ from torch for this "
            "checkpoint (only single-token suppression is implemented)",
            stacklevel=2)
    feos = gen.get("forced_eos_token_id")
    defaults = {
        "num_beams": int(gen.get("num_beams") or 1),
        "max_length": int(gen.get("max_length") or 512),
        "length_penalty": float(gen.get("length_penalty") or 1.0),
        "suppress_tokens": tuple(suppress),
        # the forced token itself: HF allows forced_eos_token_id !=
        # eos_token_id, so a bool would force the wrong token
        "forced_eos": int(feos) if feos is not None else False,
        "name": os.path.basename(os.path.normpath(ckpt_dir)),
    }
    return cfg, sd, defaults
