"""Write the port's weights as HF / sentence-transformers files — counterpart
of ``qst_tpu/models/hf_export.py`` (``export_state_dict``, :111, and
``save_torch_state_dict``, :119).

The port's state dict already carries HF ``BertModel`` / ``MPNetModel``
names (RoBERTa's are BERT's, as in the source's ``export_state_dict``), so
the export is a copy into float32 numpy arrays (no pooler).
``save_checkpoint_dir`` writes a whole directory — ``config.json``, the
weights as ``model.safetensors`` or ``pytorch_model.bin``, the vocabulary
(``vocab.txt``, or ``vocab.json`` + ``merges.txt`` for byte-level BPE),
``sentence_bert_config.json`` and ``1_Pooling/config.json`` — that
``models/hf_import.load_hf_checkpoint_dir`` and the JAX package's loader
read; ``save_cross_encoder_dir`` writes a ``CrossEncoderModule``'s as an HF
``*ForSequenceClassification`` directory (num_labels 1) for
``load_cross_encoder_dir``; ``save_marian_dir`` writes a ``MarianModule``'s
(``models/seq2seq.py``) as an HF ``MarianMTModel`` directory for
``load_marian_dir``. ``export_bert_state_dict`` and
``export_mpnet_state_dict`` are the JAX package's names (``:23``, ``:69``):
the trunk alone, checked against cfg (``hf_import.select_trunk``).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from qst_tpu_torch.core.config import EncoderConfig
from qst_tpu_torch.models.hf_import import select_trunk, write_safetensors


def _numpy(sd: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().float().cpu().numpy().copy() for k, v in sd.items()}


def export_state_dict(state_dict: Mapping[str, torch.Tensor],
                      cfg: EncoderConfig) -> Dict[str, np.ndarray]:
    """The port's state dict → an HF ``BertModel`` / ``MPNetModel`` state
    dict of float32 numpy arrays (no pooler); RoBERTa has BERT's layout."""
    if cfg.arch not in ("bert", "roberta", "mpnet"):
        raise ValueError(f"unknown arch {cfg.arch!r}")
    return _numpy(state_dict)


def export_bert_state_dict(state_dict: Mapping[str, torch.Tensor],
                           cfg: EncoderConfig) -> Dict[str, np.ndarray]:
    """A ``BertEncoder`` / ``SentenceEncoderModule`` state dict → an HF
    ``BertModel`` state dict of float32 numpy arrays (no pooler, no heads);
    raises where a tensor of cfg's BERT trunk is missing or has another
    shape."""
    return _numpy(select_trunk(state_dict, cfg, "roberta" if cfg.arch == "roberta" else "bert"))


def export_mpnet_state_dict(state_dict: Mapping[str, torch.Tensor],
                            cfg: EncoderConfig) -> Dict[str, np.ndarray]:
    """An ``MPNetEncoder`` / ``SentenceEncoderModule`` state dict → an HF
    ``MPNetModel`` state dict of float32 numpy arrays (no pooler); raises
    where a tensor of cfg's MPNet trunk is missing or has another shape."""
    return _numpy(select_trunk(state_dict, cfg, "mpnet"))


def save_torch_state_dict(state_dict: Mapping[str, torch.Tensor], cfg: EncoderConfig,
                          path: str) -> None:
    """Write a ``pytorch_model.bin`` loadable by transformers."""
    _write_weights(export_state_dict(state_dict, cfg), path)


def hf_config(cfg: EncoderConfig) -> dict:
    """The ``config.json`` of an HF ``BertModel`` / ``RobertaModel`` /
    ``MPNetModel`` with cfg's widths."""
    out = {
        "architectures": [{"mpnet": "MPNetModel", "roberta": "RobertaModel"}.get(
            cfg.arch, "BertModel")],
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
    if cfg.arch in ("bert", "roberta"):
        out["type_vocab_size"] = cfg.type_vocab_size
    else:
        out["relative_attention_num_buckets"] = 32
    return out


Vocab = Union[Sequence[str], Mapping[str, int]]


def _write_weights(sd: Mapping[str, np.ndarray], path: str) -> None:
    if path.endswith(".safetensors"):
        write_safetensors(sd, path)
    else:
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)


def _write_vocab(ckpt_dir: str, vocab: Optional[Vocab],
                 merges: Optional[Sequence[Tuple[str, str]]]) -> None:
    """A list of tokens → ``vocab.txt``, one a line (WordPiece); a mapping
    token → id → ``vocab.json``, with ``merges`` as ``merges.txt``
    (byte-level BPE)."""
    if vocab is None:
        return
    if isinstance(vocab, Mapping):
        with open(os.path.join(ckpt_dir, "vocab.json"), "w", encoding="utf-8") as f:
            json.dump(dict(vocab), f, ensure_ascii=False)
        with open(os.path.join(ckpt_dir, "merges.txt"), "w", encoding="utf-8") as f:
            f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges or ()))
        return
    with open(os.path.join(ckpt_dir, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")


def _check_weights_name(weights: str) -> None:
    if weights not in ("model.safetensors", "pytorch_model.bin"):
        raise ValueError(f"weights must be model.safetensors or pytorch_model.bin, got {weights}")


def save_checkpoint_dir(state_dict: Mapping[str, torch.Tensor], cfg: EncoderConfig,
                        ckpt_dir: str, vocab: Optional[Vocab] = None,
                        weights: str = "model.safetensors",
                        merges: Optional[Sequence[Tuple[str, str]]] = None) -> str:
    """Write a sentence-transformers-style directory for ``state_dict``:
    ``config.json``, ``weights`` (``model.safetensors`` or
    ``pytorch_model.bin``), the vocabulary when ``vocab`` is given (a token
    list → ``vocab.txt``; a token → id mapping → ``vocab.json`` and
    ``merges`` → ``merges.txt``), ``sentence_bert_config.json``
    (cfg.max_seq_length) and ``1_Pooling/config.json`` (cfg.pooling).
    → ``ckpt_dir``."""
    _check_weights_name(weights)
    os.makedirs(os.path.join(ckpt_dir, "1_Pooling"), exist_ok=True)
    with open(os.path.join(ckpt_dir, "config.json"), "w") as f:
        json.dump(hf_config(cfg), f, indent=2)
    _write_weights(export_state_dict(state_dict, cfg), os.path.join(ckpt_dir, weights))
    _write_vocab(ckpt_dir, vocab, merges)
    with open(os.path.join(ckpt_dir, "sentence_bert_config.json"), "w") as f:
        json.dump({"max_seq_length": cfg.max_seq_length, "do_lower_case": False}, f)
    with open(os.path.join(ckpt_dir, "1_Pooling", "config.json"), "w") as f:
        json.dump({"word_embedding_dimension": cfg.hidden_size,
                   "pooling_mode_cls_token": cfg.pooling == "cls",
                   "pooling_mode_mean_tokens": cfg.pooling == "mean",
                   "pooling_mode_max_tokens": cfg.pooling == "max"}, f)
    return ckpt_dir


def save_cross_encoder_dir(state_dict: Mapping[str, torch.Tensor], cfg: EncoderConfig,
                           ckpt_dir: str, vocab: Optional[Vocab] = None,
                           weights: str = "model.safetensors",
                           merges: Optional[Sequence[Tuple[str, str]]] = None) -> str:
    """Write a ``CrossEncoderModule`` state dict as an HF
    ``RobertaForSequenceClassification`` / ``BertForSequenceClassification``
    directory (num_labels 1): ``config.json``, the weights with the trunk
    under ``roberta.`` / ``bert.`` and the ``classifier.*`` keys as they
    are, and the vocabulary as ``save_checkpoint_dir`` writes it.
    → ``ckpt_dir``."""
    _check_weights_name(weights)
    if cfg.arch not in ("bert", "roberta"):
        raise ValueError(f"a cross-encoder has a bert or roberta trunk, got {cfg.arch!r}")
    os.makedirs(ckpt_dir, exist_ok=True)
    config = hf_config(cfg)
    config["architectures"] = [("Roberta" if cfg.arch == "roberta" else "Bert")
                               + "ForSequenceClassification"]
    config.update(num_labels=1, id2label={"0": "LABEL_0"}, label2id={"LABEL_0": 0})
    with open(os.path.join(ckpt_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    sd = {(k if k.startswith("classifier") else f"{cfg.arch}.{k}"): v
          for k, v in export_state_dict(state_dict, cfg).items()}
    _write_weights(sd, os.path.join(ckpt_dir, weights))
    _write_vocab(ckpt_dir, vocab, merges)
    return ckpt_dir


def save_marian_dir(state_dict: Mapping[str, torch.Tensor], cfg, ckpt_dir: str,
                    generation: Optional[dict] = None,
                    weights: str = "model.safetensors") -> str:
    """Write a ``MarianModule`` state dict (``models/seq2seq.py``) as an HF
    ``MarianMTModel`` directory: ``config.json`` with cfg's widths, the
    weights under their HF names, and ``generation_config.json`` holding
    ``generation`` when given (``num_beams``, ``max_length``,
    ``bad_words_ids``, ``forced_eos_token_id``, ...). ``load_marian_dir``
    and the JAX package's loader read it. → ``ckpt_dir``."""
    _check_weights_name(weights)
    os.makedirs(ckpt_dir, exist_ok=True)
    config = {
        "architectures": ["MarianMTModel"], "model_type": "marian",
        "vocab_size": cfg.vocab_size, "decoder_vocab_size": cfg.vocab_size,
        "d_model": cfg.d_model, "encoder_layers": cfg.encoder_layers,
        "decoder_layers": cfg.decoder_layers, "encoder_attention_heads": cfg.num_heads,
        "decoder_attention_heads": cfg.num_heads, "encoder_ffn_dim": cfg.ffn_dim,
        "decoder_ffn_dim": cfg.ffn_dim, "max_position_embeddings": cfg.max_position_embeddings,
        "pad_token_id": cfg.pad_token_id, "eos_token_id": cfg.eos_token_id,
        "decoder_start_token_id": cfg.decoder_start_token_id,
        "scale_embedding": cfg.scale_embedding, "activation_function": cfg.activation,
        "share_encoder_decoder_embeddings": True, "tie_word_embeddings": True,
        "dropout": 0.0, "attention_dropout": 0.0, "activation_dropout": 0.0,
    }
    with open(os.path.join(ckpt_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    if generation is not None:
        with open(os.path.join(ckpt_dir, "generation_config.json"), "w") as f:
            json.dump(generation, f, indent=2)
    _write_weights(_numpy(state_dict), os.path.join(ckpt_dir, weights))
    return ckpt_dir
