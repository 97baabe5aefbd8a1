"""Operations and bytes of the work a layer's mathematics needs, counted on
real tokens (the attention masks), whatever computes it; and the table of
peaks they are held against.

An encoder layer on a sequence of L real tokens, width H, FFN width F:
``2·L·(4H² + 2HF)`` for its four projections and the FFN, plus
``4·L²·H`` for the scores and the weighted sum; its backward twice that.
Its bytes: the bf16 weights read once, the bf16 input read and the output
written once.

Peaks: NVIDIA's data sheet for the H100 SXM, dense: 989 TFLOP/s in bf16,
3.35 TB/s of HBM3, at its 700 W limit; the card's own limit is reported
beside every share.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Optional

PEAKS = {"H100": {"bf16_flops": 989e12, "hbm_bytes": 3.35e12}}


def peak(device_name: str) -> Optional[dict]:
    for key, p in PEAKS.items():
        if key in device_name:
            return p
    return None


def layer_flops(cfg: Mapping, lengths: Iterable[int]) -> float:
    H, F = cfg["hidden_size"], cfg["intermediate_size"]
    per_token = 2 * (4 * H * H + 2 * H * F)
    return float(sum(per_token * L + 4 * L * L * H for L in lengths))


def layer_bytes(cfg: Mapping, lengths: Iterable[int], launches: int = 1, elem: int = 2) -> float:
    """A layer's weights read once a launch, its input read and output written once."""
    H, F = cfg["hidden_size"], cfg["intermediate_size"]
    tokens = sum(lengths)
    return float(launches * elem * (4 * H * H + 2 * H * F) + 2 * elem * tokens * H)


def encoder_flops(cfg: Mapping, lengths) -> float:
    return cfg["num_hidden_layers"] * layer_flops(cfg, lengths)


def train_flops(cfg: Mapping, lengths) -> float:
    """Forward and backward of every layer: three times the forward."""
    return 3 * encoder_flops(cfg, lengths)


def roofline_pct(flops: float, nbytes: float, seconds: float, device_name: str) -> Optional[float]:
    """The least time the work could take over the time it took, in %."""
    p = peak(device_name)
    if p is None or seconds <= 0 or flops <= 0:
        return None
    return 100.0 * max(flops / p["bf16_flops"], nbytes / p["hbm_bytes"]) / seconds


def mfu_pct(flops: float, seconds: float, device_name: str) -> Optional[float]:
    p = peak(device_name)
    if p is None or seconds <= 0 or flops <= 0:
        return None
    return 100.0 * flops / (p["bf16_flops"] * seconds)
