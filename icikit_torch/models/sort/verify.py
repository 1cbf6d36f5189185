"""Distributed sorted-order verifier.

Reference ``check_sort`` (``Parallel-Sorting/src/psort.cc:497-520``):
count local adjacent-pair inversions, pass each rank's max to its right
neighbour for the boundary check, and sum the error counts; a correct
run reports 0 errors. Across processes the boundary message crosses the
transport's process backend and the counts sum by its all-reduce.
"""

from __future__ import annotations

import torch

from icikit_torch.parallel import transport
from icikit_torch.parallel.shmap import (my_ranks, on_mesh,
                                         partial_shift_perm, reduce_ranks)
from icikit_torch.parallel.transport import index
from icikit_torch.utils.mesh import DEFAULT_AXIS, RankMesh


def check_sort_shard(a: torch.Tensor) -> torch.Tensor:
    """Inversion count of rank-vectorised (p, n_loc) data: inversions
    inside each row plus, for every rank r > 0, whether rank r-1's last
    element exceeds rank r's first. A 0-d int64 tensor."""
    local = (a[:, 1:] < a[:, :-1]).sum()
    boundary = (a[:-1, -1] > a[1:, 0]).sum()
    return local + boundary


def _check_sort_processes(a: torch.Tensor, p: int) -> torch.Tensor:
    """:func:`check_sort_shard` under a process view: each rank's last
    element travels to its right neighbour (the reference's boundary
    message), and the counts sum over the processes."""
    local = (a[:, 1:] < a[:, :-1]).sum()
    prev_last = transport.ppermute(a[:, -1:], partial_shift_perm(p, 1))
    has_left = index(tuple(r > 0 for r in my_ranks(p)), a.device,
                     torch.bool)
    boundary = ((prev_last[:, 0] > a[:, 0]) & has_left).sum()
    return reduce_ranks((local + boundary).reshape(1), "sum")


def check_sort(x2d: torch.Tensor, mesh: RankMesh | None = None,
               axis: str = DEFAULT_AXIS) -> int:
    """Total inversion count of (p, n_loc) data. 0 iff globally sorted
    ascending. Across processes ``x2d`` holds this process's ranks and
    the count is the whole axis's, the same on every process."""
    procs = 1 if mesh is None else getattr(mesh, "procs", 1)
    if mesh is not None and x2d.shape[0] != mesh.shape[axis] // procs:
        raise ValueError(f"leading dim {x2d.shape[0]} != p="
                         f"{mesh.shape[axis] // procs}")
    if procs == 1:
        return int(check_sort_shard(x2d))
    with on_mesh(mesh, axis):
        return int(_check_sort_processes(x2d, mesh.shape[axis]))
