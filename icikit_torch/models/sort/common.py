"""Shared plumbing for the distributed sorts: padding and blocking."""

from __future__ import annotations

import torch

from icikit_torch.utils.dtypes import sentinel_for
from icikit_torch.utils.mesh import (DEFAULT_AXIS, RankMesh, mesh_axis_size,
                                     shard_along)


def ceil_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def prepare_blocks(x: torch.Tensor, mesh: RankMesh,
                   axis: str = DEFAULT_AXIS, pow2_local: bool = False,
                   fill=None):
    """Pad flat ``x`` to p equal blocks on the mesh's device.

    The reference spreads the remainder over low ranks
    (``psort.cc:556-562``); equal blocks keep shapes regular. ``fill``
    defaults to the dtype sentinel, which sorts to the global tail.
    Returns ((p, n_loc) tensor, n_loc).
    """
    p = mesh_axis_size(mesh, axis)
    n = x.shape[0]
    n_loc = max(1, -(-n // p))
    if pow2_local:
        n_loc = next_pow2(n_loc)
    total = n_loc * p
    x = x.to(mesh.device)
    if total != n:
        if fill is None:
            fill = sentinel_for(x.dtype)
        pad = torch.full((total - n,), fill, dtype=x.dtype, device=x.device)
        x = torch.cat([x, pad])
    return shard_along(x.reshape(p, n_loc), mesh, axis), n_loc


def take_sorted(out2d: torch.Tensor, n: int) -> torch.Tensor:
    """Strip sentinel padding from the sorted (p, n_loc) result."""
    return out2d.reshape(-1)[:n]
