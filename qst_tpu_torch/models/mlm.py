"""Masked-language-model head over the BERT trunk — counterpart of
``qst_tpu/models/mlm.py``.

Backs the MLM insert/substitute augmentation (``augment/mlm.py``) that the
reference takes from ``nlpaug.ContextualWordEmbsAug``. The head is the
source's: dense → exact GELU → LayerNorm → vocabulary projection, all in
f32 over the trunk's last hidden state (parameter names ``transform``,
``transform_layer_norm``, ``decoder`` beside the trunk's ``embeddings`` and
``encoder``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch
import torch.nn.functional as F
from torch import nn

from qst_tpu_torch.core.config import EncoderConfig
from qst_tpu_torch.models.bert import BertEncoder
from qst_tpu_torch.models.sentence_encoder import init_state_dict


class BertMLMModule(nn.Module):
    """ids/mask → per-position vocab logits (B, S, V), f32."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        trunk = BertEncoder(cfg)
        self.cfg = cfg
        self.embeddings = trunk.embeddings
        self.encoder = trunk.encoder
        self.transform = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.transform_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.decoder = nn.Linear(cfg.hidden_size, cfg.vocab_size)

    def hidden(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """The head's input before the vocabulary projection: (B, S, H) f32."""
        h = BertEncoder.forward(self, input_ids, attention_mask)
        h = F.gelu(self.transform(h.float()), approximate="none")
        return self.transform_layer_norm(h)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.hidden(input_ids, attention_mask))


def init_mlm_params(cfg: EncoderConfig, generator: torch.Generator,
                    device: Any = None) -> Dict[str, torch.Tensor]:
    """Random weights of a ``BertMLMModule`` from ``generator`` (a CPU
    generator), on ``device`` (default: the GPU), from the distribution of
    the source's Flax init (``init_state_dict``)."""
    return init_state_dict(BertMLMModule(cfg), generator, device)


def mlm_module(cfg: EncoderConfig, params: Dict[str, torch.Tensor]) -> BertMLMModule:
    """A ``BertMLMModule`` in eval mode holding ``params``, on their device."""
    device = next(iter(params.values())).device
    with torch.device("meta"):
        model = BertMLMModule(cfg)
    model = model.to_empty(device=device)
    model.load_state_dict(params)
    return model.eval().requires_grad_(False)


def mlm_logits_fn(cfg: EncoderConfig) -> Callable:
    """The forward: (params, ids, mask) → (B, S, V) f32 logits, on the
    params' device (the module is built again only for another params
    dict)."""
    built: list = [None, None]          # (params, module) of the last call

    def fwd(params, input_ids, attention_mask):
        if built[0] is not params:
            built[:] = [params, mlm_module(cfg, params)]
        model = built[1]
        dev = next(model.parameters()).device
        with torch.no_grad():
            return model(torch.as_tensor(input_ids).long().to(dev),
                         torch.as_tensor(attention_mask).long().to(dev))

    return fwd
