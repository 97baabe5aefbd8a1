"""The precision of the reference's products.

``"f32"``: float32 operands and sums with TF32 off (``strict_f32``).
``"fp8"``: the control, one step below the configurations' bfloat16
compute: both operands of every product are rounded to float8 e4m3 under a
per-tensor scale (amax / 448), then multiplied in float32. Gradients pass
the rounding unchanged (straight through), so a training step's backward
products take the rounded forward operands.
"""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0


@contextlib.contextmanager
def strict_f32():
    """Float32 products without TF32, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


class _RoundFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        scale = t.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
        return (t / scale).to(torch.float8_e4m3fn).float() * scale

    @staticmethod
    def backward(ctx, g):
        return g


def rounded(t: torch.Tensor, precision: str) -> torch.Tensor:
    """``t`` as a product's operand in ``precision``."""
    if precision == "f32":
        return t
    if precision == "fp8":
        return _RoundFp8.apply(t)
    raise ValueError(f"unknown precision {precision!r}")


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    return rounded(a, precision) @ rounded(b, precision)


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    return torch.einsum(eq, rounded(a, precision), rounded(b, precision))
