"""Cross-encoder pair scorer — counterpart of ``qst_tpu/models/cross_encoder.py``.

The ``CrossEncoder("cross-encoder/stsb-roberta-large")`` relevance labeler
the reference uses to build IR relevance sets (threshold 0.4): the BERT /
RoBERTa trunk of ``models/bert.py`` over the framed (query, doc) pair, the
CLS row in f32, a regression head, and a sigmoid to [0, 1].

Parameter names follow HF ``*ForSequenceClassification`` with the trunk's
prefix stripped (``embeddings.*``, ``encoder.*``, then ``classifier.dense`` +
``classifier.out_proj`` for RoBERTa, one ``classifier`` for BERT), so a
checkpoint's state dict (``hf_import.load_cross_encoder_dir``) loads as it
is. The trunk keeps the encoder's routes: ``cfg.use_flash_attention``
sends its attention through K7 at S a multiple of 128.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from qst_tpu_torch.core.config import EncoderConfig
from qst_tpu_torch.core.device import resolve_device
from qst_tpu_torch.models.bert import BertEncoder, _dropout
from qst_tpu_torch.models.sentence_encoder import init_state_dict


class RobertaClassificationHead(nn.Module):
    """HF ``RobertaClassificationHead`` (the head of stsb-roberta-large):
    dense → tanh → dropout → out_proj, all f32."""

    def __init__(self, hidden_size: int):
        super().__init__()
        self.dense = nn.Linear(hidden_size, hidden_size)
        self.out_proj = nn.Linear(hidden_size, 1)


class CrossEncoderModule(nn.Module):
    """(ids, mask, token types) → (B,) relevance logits."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        trunk = BertEncoder(cfg)
        self.cfg = cfg
        self.embeddings = trunk.embeddings
        self.encoder = trunk.encoder
        if cfg.arch == "roberta":
            self.classifier = RobertaClassificationHead(cfg.hidden_size)
        else:
            self.classifier = nn.Linear(cfg.hidden_size, 1)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: torch.Tensor,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        rate = self.cfg.hidden_dropout
        hidden = BertEncoder.forward(self, input_ids, attention_mask, token_type_ids,
                                     dropout_generator)
        cls = _dropout(self, hidden[:, 0, :].float(), rate, dropout_generator)
        if self.cfg.arch == "roberta":
            cls = torch.tanh(self.classifier.dense(cls))
            cls = _dropout(self, cls, rate, dropout_generator)
            logit = self.classifier.out_proj(cls)
        else:
            logit = self.classifier(cls)
        return logit.squeeze(-1)


def init_cross_encoder(cfg: EncoderConfig, generator: torch.Generator,
                       device: Any = None) -> Dict[str, torch.Tensor]:
    """Random weights of a ``CrossEncoderModule`` from ``generator`` (a CPU
    generator), on ``device`` (default: the GPU), from the distribution of
    the source's Flax init (``init_state_dict``)."""
    return init_state_dict(CrossEncoderModule(cfg), generator, device)


class CrossEncoder:
    """Host wrapper: (query, doc) pairs → relevance scores in [0, 1].

    ``params``: a ``CrossEncoderModule`` state dict; ``tokenizer``: anything
    with ``batch_encode_pairs(pairs, max_length) -> (ids, mask, types)``;
    ``device``: where the model runs (default: the GPU)."""

    def __init__(self, cfg: EncoderConfig, params: Mapping[str, torch.Tensor],
                 tokenizer: Any, device: Any = None):
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.device = resolve_device(device)
        with torch.device("meta"):
            model = CrossEncoderModule(cfg)
        self.model = model.to_empty(device=self.device)
        self.model.load_state_dict(params)
        self.model.eval().requires_grad_(False)

    def predict(self, pairs: Sequence[Tuple[str, str]], batch_size: int = 128) -> np.ndarray:
        """Scores of ``pairs`` in order, ``batch_size`` pairs a forward; the
        last chunk is padded to ``batch_size`` rows (pad rows attend to
        their first token), as the source pads it to the compiled shape."""
        scores = []
        for start in range(0, len(pairs), batch_size):
            chunk = list(pairs[start:start + batch_size])
            ids, mask, types = self.tokenizer.batch_encode_pairs(
                chunk, max_length=self.cfg.max_seq_length)
            n = len(chunk)
            if n < batch_size:  # pad batch to fixed shape
                pad = batch_size - n
                ids = np.concatenate([ids, np.zeros((pad, ids.shape[1]), ids.dtype)])
                mask_pad = np.zeros((pad, mask.shape[1]), mask.dtype)
                mask_pad[:, 0] = 1
                mask = np.concatenate([mask, mask_pad])
                types = np.concatenate([types, np.zeros((pad, types.shape[1]), types.dtype)])
            dev = self.device
            with torch.no_grad():
                logits = self.model(torch.from_numpy(ids.astype(np.int64)).to(dev),
                                    torch.from_numpy(mask.astype(np.int64)).to(dev),
                                    torch.from_numpy(types.astype(np.int64)).to(dev))
            scores.append(torch.sigmoid(logits[:n]).cpu().numpy())
        return np.concatenate(scores) if scores else np.zeros((0,), np.float32)
