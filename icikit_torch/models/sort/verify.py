"""Distributed sorted-order verifier.

Reference ``check_sort`` (``Parallel-Sorting/src/psort.cc:497-520``):
count local adjacent-pair inversions, pass each rank's max to its right
neighbour for the boundary check, and sum the error counts; a correct
run reports 0 errors.
"""

from __future__ import annotations

import torch

from icikit_torch.utils.mesh import DEFAULT_AXIS, RankMesh


def check_sort_shard(a: torch.Tensor) -> torch.Tensor:
    """Inversion count of rank-vectorised (p, n_loc) data: inversions
    inside each row plus, for every rank r > 0, whether rank r-1's last
    element exceeds rank r's first. A 0-d int64 tensor."""
    local = (a[:, 1:] < a[:, :-1]).sum()
    boundary = (a[:-1, -1] > a[1:, 0]).sum()
    return local + boundary


def check_sort(x2d: torch.Tensor, mesh: RankMesh | None = None,
               axis: str = DEFAULT_AXIS) -> int:
    """Total inversion count of (p, n_loc) data. 0 iff globally sorted
    ascending."""
    if mesh is not None and x2d.shape[0] != mesh.shape[axis]:
        raise ValueError(f"leading dim {x2d.shape[0]} != p="
                         f"{mesh.shape[axis]}")
    return int(check_sort_shard(x2d))
