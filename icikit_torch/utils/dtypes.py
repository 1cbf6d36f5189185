"""Dtype helpers shared across layers."""

from __future__ import annotations

import torch

_FLOATS = (torch.float32, torch.bfloat16, torch.float16, torch.float64)


def sentinel_for(dtype: torch.dtype):
    """Largest representable value — pads buffers so padding sorts
    last (+inf for floats, the integer max otherwise)."""
    if dtype in _FLOATS:
        return float("inf")
    return torch.iinfo(dtype).max
