"""Located reductions and distributed top-k, rank-vectorised.

``MPI_MAXLOC``/``MPI_MINLOC`` return *where* the extremum lives as well
as its value; ``top_k_dist`` generalizes from 1 to k via local top-k,
an allgather of the k p candidates and a final top-k, so the candidates
move, never the data. Both return *global element indices* (rank times
block plus offset), as ``icikit.parallel.reduceloc`` does, with its tie
rules: the lowest global index wins a tie, and the top-k keeps the
lower index first (a stable sort, since ``torch.topk`` promises no
order among ties).

Across processes (a mesh split over ``torch.distributed`` processes)
``x`` holds this process's ranks: the value and the index reduce over
the processes by the backend's all-reduce, the top-k's candidates are
gathered by its all-gather (``shmap.reduce_ranks``, ``gather_ranks``),
and every process returns the same answer.
"""

from __future__ import annotations

import torch

from icikit_torch.parallel.shmap import (gather_ranks, on_mesh, rank_ids,
                                         reduce_ranks)
from icikit_torch.utils.mesh import DEFAULT_AXIS


def _check_blocks(x: torch.Tensor, mesh, axis: str) -> None:
    p = mesh.shape[axis] // getattr(mesh, "procs", 1)
    if x.dim() != 2 or x.shape[0] != p:
        raise ValueError(
            f"expected one (n,) block per device: (p={p}, n) input, "
            f"got {tuple(x.shape)}")


def _global_index(local: torch.Tensor, n: int, p: int) -> torch.Tensor:
    """Rank r's offsets ``local[r]`` as int32 global indices r n + o
    (the rows being this process's ranks of p)."""
    ranks = rank_ids(p, local.device)
    return (ranks.view(-1, *([1] * (local.dim() - 1))) * n
            + local).to(torch.int32)


def allreduce_loc(x: torch.Tensor, mesh, axis: str = DEFAULT_AXIS,
                  op: str = "maxloc"):
    """``MPI_Allreduce`` with ``MPI_MAXLOC``/``MPI_MINLOC`` semantics.

    Args:
      x: ``(p, n)``; row d is rank d's block.
      op: "maxloc" or "minloc".

    Returns:
      ``(value, global_index)``, 0-d tensors (every rank's copy is the
      same); the index is into the flattened global array, ties to the
      lowest index.
    """
    if op not in ("maxloc", "minloc"):
        raise ValueError(f"op must be 'maxloc' or 'minloc', got {op!r}")
    _check_blocks(x, mesh, axis)
    x = x.to(mesh.device)
    p = mesh.shape[axis]
    with on_mesh(mesh, axis):
        local_idx = x.argmax(1) if op == "maxloc" else x.argmin(1)
        local_val = x.gather(1, local_idx[:, None])[:, 0]
        best = reduce_ranks(local_val, "max" if op == "maxloc" else "min")
        # lowest global index among ranks holding the extremum
        cand = torch.where(local_val == best,
                           _global_index(local_idx, x.shape[1], p),
                           torch.iinfo(torch.int32).max)
        return best, reduce_ranks(cand, "min")


def _best(vals: torch.Tensor, k: int, largest: bool):
    """The k best along the last dim, ties to the lower index first.
    Smallest-k sorts an order-reversing transform that cannot overflow:
    bitwise NOT for integers (INT_MIN -> INT_MAX) and bool, negation
    for floats."""
    if largest:
        key = vals
    elif vals.dtype == torch.bool:
        key = (~vals).to(torch.int32)
    elif not vals.dtype.is_floating_point:
        key = ~vals
    else:
        key = -vals
    idx = torch.sort(key, dim=-1, descending=True, stable=True).indices
    idx = idx[..., :k]
    return vals.gather(-1, idx), idx


def top_k_dist(x: torch.Tensor, mesh, k: int, axis: str = DEFAULT_AXIS,
               largest: bool = True):
    """The k global extrema of rank-sharded data and their indices.

    Args:
      x: ``(p, n)`` with ``n >= k`` (each rank must contribute k
        candidates for the global answer to be exact).

    Returns:
      ``(values (k,), global_indices (k,))``, sorted best-first.
    """
    _check_blocks(x, mesh, axis)
    n = x.shape[1]
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if k > n:
        raise ValueError(
            f"k={k} exceeds the per-device block ({n}): a device "
            f"cannot contribute enough candidates for exactness; "
            f"reshape to larger blocks or reduce k")
    x = x.to(mesh.device)
    p = mesh.shape[axis]
    with on_mesh(mesh, axis):
        lv, li = _best(x, min(k, n), largest)
        # candidate pool: every rank's local top-k, in rank order
        vals = gather_ranks(lv).reshape(-1)
        idxs = gather_ranks(_global_index(li, n, p)).reshape(-1)
    fv, fi = _best(vals, k, largest)
    return fv, idxs[fi]
