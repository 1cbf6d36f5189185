"""Rotary position embeddings, split-half (NeoX) convention.

Pair ``j`` of the head dimension, ``(x[..., j], x[..., j + d/2])``, is
rotated at position ``m`` by the angle ``m * theta^(-2j/d)``. The math
is float32 and the output keeps the input's dtype, as in
``icikit.ops.rope``.
"""

from __future__ import annotations

import torch


def rope_angles(positions: torch.Tensor, d: int,
                theta: float = 10000.0) -> torch.Tensor:
    """float32 angles ``(..., s, d/2)`` for positions ``(s,)`` or
    ``(b, s)``."""
    if d % 2:
        raise ValueError(f"head dim must be even for RoPE, got {d}")
    exps = -torch.arange(0, d, 2, dtype=torch.float32,
                         device=positions.device) / d
    inv = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                 device=positions.device), exps)
    return positions.to(torch.float32)[..., :, None] * inv


def rope_sincos(positions: torch.Tensor, d: int, theta: float = 10000.0):
    """``(cos, sin)`` tables, each ``(s, d/2)`` float32 (``(b, s, d/2)``
    for per-row positions)."""
    ang = rope_angles(positions, d, theta)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor | None,
               theta: float = 10000.0, sincos=None) -> torch.Tensor:
    """Rotate ``x (b, s, h, d)`` by its positions ``(s,)`` or ``(b, s)``,
    keeping the dtype. ``sincos``: precomputed :func:`rope_sincos`
    tables (``positions`` is then ignored)."""
    d = x.shape[-1]
    if sincos is None:
        sincos = rope_sincos(positions, d, theta)
    if sincos[0].dim() == 3:               # per-row tables (b, s, d/2)
        cos, sin = sincos[0][:, :, None, :], sincos[1][:, :, None, :]
    else:                                  # shared tables (s, d/2)
        cos, sin = sincos[0][None, :, None, :], sincos[1][None, :, None, :]
    x1 = x[..., :d // 2].to(torch.float32)
    x2 = x[..., d // 2:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
