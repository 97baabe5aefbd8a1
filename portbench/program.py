"""The program's objects as a cell's configuration states them.

``encoder_config`` maps a configuration file's Hugging Face keys onto the
port's ``EncoderConfig``; ``tokenizer`` loads the port's tokenizer over a
vocabulary file the benchmark wrote (the native WordPiece where g++ builds
it, which is at ``qst_tpu_torch/native/_build/`` inside the checkout).
"""

from __future__ import annotations

from typing import Any, Mapping


def encoder_config(cfg: Mapping[str, Any], **overrides: Any):
    from qst_tpu_torch.core.config import EncoderConfig

    fields = dict(
        name=cfg["preset"], arch=cfg["model_type"], vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"], num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"], intermediate_size=cfg["intermediate_size"],
        max_position_embeddings=cfg["max_position_embeddings"],
        layer_norm_eps=cfg["layer_norm_eps"], hidden_dropout=cfg["hidden_dropout_prob"],
        attention_dropout=cfg["attention_probs_dropout_prob"],
        max_seq_length=cfg["max_seq_length"], pooling=cfg["pooling"],
        normalize=cfg["normalize"], dtype=cfg["compute_dtype"],
        pad_token_id=cfg["pad_token_id"], use_fused_layer=True)
    if cfg["model_type"] != "mpnet":
        fields["type_vocab_size"] = cfg["type_vocab_size"]
    fields.update(overrides)
    return EncoderConfig(**fields)


def same_encoder(a, b) -> list:
    """The fields in which two ``EncoderConfig``s differ."""
    import dataclasses

    return [f.name for f in dataclasses.fields(a) if getattr(a, f.name) != getattr(b, f.name)]


def tokenizer(vocab_path: str):
    from qst_tpu_torch.models.tokenizer import load_tokenizer

    return load_tokenizer(vocab_path)
