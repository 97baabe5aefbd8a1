"""Pair discriminator for the d-regularized quadruplet loss — counterpart
of ``qst_tpu/models/discriminator.py``.

concat(anchor, x) → [Linear → ReLU]* → Linear → one logit per pair, (B, 1).
Depth 1 (no hidden layers) is the reference notebook's ``DummyDiscriminator``.
Layer names follow the Flax module (``hidden_i``, ``logit``) so
``state_dict_from_flax_params`` carries its weights across.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch
from torch import nn

from qst_tpu_torch.core.device import resolve_device


class PairDiscriminator(nn.Module):
    def __init__(self, embed_dim: int, hidden_sizes: Sequence[int] = ()):
        super().__init__()
        sizes = [2 * embed_dim, *hidden_sizes]
        self.hidden = nn.ModuleList(nn.Linear(i, o) for i, o in zip(sizes, sizes[1:]))
        self.logit = nn.Linear(sizes[-1], 1)

    def forward(self, anchor: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        h = torch.cat([anchor, x], dim=-1).float()
        for layer in self.hidden:
            h = torch.relu(layer(h))
        return self.logit(h)  # (B, 1)


def init_discriminator(embed_dim: int, generator: torch.Generator,
                       hidden_sizes: Sequence[int] = (), device: Any = None
                       ) -> PairDiscriminator:
    """A discriminator with Flax ``Dense``'s initialisation: LeCun-normal
    kernels (truncated at two standard deviations) and zero biases, drawn
    from ``generator`` (a CPU generator); on ``device`` (default: the GPU)."""
    device = resolve_device(device)
    model = PairDiscriminator(embed_dim, hidden_sizes)
    with torch.no_grad():
        for lin in [*model.hidden, model.logit]:
            std = math.sqrt(1.0 / lin.in_features) / 0.87962566103423978
            nn.init.trunc_normal_(lin.weight, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            lin.bias.zero_()
    return model.to(device)


def state_dict_from_flax_params(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The Flax ``PairDiscriminator`` params → this module's state dict."""
    sd: Dict[str, torch.Tensor] = {}
    names = sorted((k for k in params if k.startswith("hidden_")),
                   key=lambda k: int(k.split("_")[1]))
    for out, name in [*((f"hidden.{i}", n) for i, n in enumerate(names)), ("logit", "logit")]:
        sd[f"{out}.weight"] = torch.from_numpy(np.array(params[name]["kernel"], np.float32).T)
        sd[f"{out}.bias"] = torch.from_numpy(np.array(params[name]["bias"], np.float32))
    return sd
