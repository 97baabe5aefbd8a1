"""The card's fixture for the harness's tests that need one."""

from __future__ import annotations

import pytest


@pytest.fixture
def card():
    """Skips where there is no CUDA card (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels have no CPU mode")
    return torch.device("cuda", 0)
