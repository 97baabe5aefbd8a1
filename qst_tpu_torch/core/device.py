"""Where the port's entry points run: on the GPU unless the caller asks
otherwise.

``resolve_device(None)`` is the current CUDA device and raises when there is
none — it never falls back to the CPU, so a run that was meant for the card
cannot pass silently on the host. Callers that want the CPU (the tests) say
``device="cpu"``. A tensor argument fixes the device on its own: functions
that receive tensors resolve through :func:`device_of` first.
"""

from __future__ import annotations

from typing import Any

import torch


def resolve_device(device: Any = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the GPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: qst_tpu_torch runs on the GPU by default — pass "
            "device='cpu' (or --device cpu) to run on the host")
    return torch.device("cuda", torch.cuda.current_device())


def device_of(value: Any, device: Any = None) -> torch.device:
    """The device an index or model built from ``value`` lives on: an
    explicit ``device`` wins, a tensor keeps its own, host data (numpy,
    lists) goes to the default of :func:`resolve_device`."""
    if device is None and isinstance(value, torch.Tensor):
        return value.device
    return resolve_device(device)

