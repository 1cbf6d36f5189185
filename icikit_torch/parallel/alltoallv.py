"""Variable-count all-to-all (``MPI_Alltoallv``), capacity-padded and
rank-vectorised.

The reference's ragged exchanges (``MPI_Alltoallv`` in the sample sorts,
``Parallel-Sorting/src/psort.cc:277,361``) as ``icikit.parallel.
alltoallv`` shapes them: fixed-capacity ``(p, cap)`` rows plus explicit
count vectors, overflow *detected* and reported instead of silently
truncated, and the padded rows riding any registered ``alltoall``
schedule. The helpers here take every rank at once on a leading rank
axis (``(p, L)`` data, ``(p, p)`` counts) where JAX's take one shard;
``pack_segments`` and ``unpack_rows`` also take one rank's operands
alone.

Layout follows MPI: each rank's send buffer holds p contiguous segments
ordered by destination (displacements = exclusive cumsum of counts); the
receive side lands as ``(p, cap)`` sentinel-padded rows ordered by
source, with the true lengths in ``recv_counts``.

Across processes (a mesh split over ``torch.distributed`` processes) the
entry points take this process's ranks as rows: the blocks and their
counts ride the schedule's exchanges through the process backend, and
the overflow count is summed over the processes, so every process
reports it.
"""

from __future__ import annotations

import torch

from icikit_torch.parallel.shmap import on_mesh, reduce_ranks
from icikit_torch.utils.dtypes import sentinel_for
from icikit_torch.utils.mesh import DEFAULT_AXIS
from icikit_torch.utils.registry import get_algorithm


def pack_segments(a: torch.Tensor, starts: torch.Tensor,
                  counts: torch.Tensor, cap: int) -> torch.Tensor:
    """Pack the p contiguous segments of ``a`` (``(..., L)``) into
    ``(..., p, cap)`` rows padded with sentinels; ``starts``/``counts``:
    ``(..., p)``. One vectorised gather, no per-bucket loop."""
    lane = torch.arange(cap, device=a.device)
    idx = (starts[..., None] + lane).clamp(0, a.shape[-1] - 1)
    valid = lane < counts[..., None]
    gathered = torch.gather(a, -1, idx.reshape(*a.shape[:-1], -1).long())
    return torch.where(valid, gathered.reshape(valid.shape),
                       sentinel_for(a.dtype))


def unpack_rows(rows: torch.Tensor, counts: torch.Tensor):
    """Flatten ``(..., p, cap)`` rows with per-row valid ``counts`` into
    ``(..., p * cap)`` whose invalid lanes are sentinels, plus the total
    count."""
    cap = rows.shape[-1]
    valid = torch.arange(cap, device=rows.device) < counts[..., None]
    flat = torch.where(valid, rows, sentinel_for(rows.dtype))
    return flat.reshape(*rows.shape[:-2], -1), counts.sum(-1)


def exchange_counts(counts: torch.Tensor, p: int,
                    algorithm: str = "xla") -> torch.Tensor:
    """Given each rank's per-destination ``counts`` ``(p, p)``, return
    the per-source counts destined to each rank, the ``MPI_Alltoall`` of
    counts at ``psort.cc:263``, carried by any registered alltoall."""
    return get_algorithm("alltoall", algorithm)(counts[..., None], p)[..., 0]


def ragged_payload(a: torch.Tensor, starts: torch.Tensor,
                   counts: torch.Tensor, cap: int, p: int | None = None,
                   algorithm: str = "xla") -> torch.Tensor:
    """The data leg of a ragged exchange alone: pack and carry, no count
    exchange or overflow sum (for a second operand routed with counts
    that ``ragged_all_to_all`` already exchanged)."""
    if p is None:
        p = counts.shape[-1]
    packed = pack_segments(a, starts, counts, cap)
    return get_algorithm("alltoall", algorithm)(packed, p)


def ragged_all_to_all(a: torch.Tensor, starts: torch.Tensor,
                      counts: torch.Tensor, cap: int, p: int | None = None,
                      algorithm: str = "xla"):
    """Send contiguous segment d of each rank's row of ``a`` to rank d;
    receive one segment per source. ``a``: ``(p, L)``; ``starts``,
    ``counts``: ``(p, p)``.

    Returns (rows ``(p, p, cap)`` sentinel-padded by source,
    recv_counts ``(p, p)``, overflow ``(p,)``): overflow counts the
    ranks with a segment over ``cap`` (content would be truncated), the
    same on every rank, for the caller to surface. Under a process view
    the leading dims are this process's ranks.
    """
    if p is None:
        p = counts.shape[-1]
    per_rank = (counts > cap).any(-1).to(torch.int32)
    overflow = reduce_ranks(per_rank, "sum").expand(per_rank.shape[0])
    rows = ragged_payload(a, starts, counts, cap, p, algorithm)
    recv_counts = exchange_counts(counts, p, algorithm).clamp_max(cap)
    return rows, recv_counts, overflow


def all_gather_v(x: torch.Tensor, counts: torch.Tensor, mesh,
                 axis: str = DEFAULT_AXIS, algorithm: str = "xla"):
    """Variable-count allgather (``MPI_Allgatherv``), capacity-padded.

    Args:
      x: ``(p, cap)``; rank d's block, whose first ``counts[d]``
        elements are valid.
      counts: ``(p,)`` int32, rank d's own count.
      algorithm: any registered ``allgather`` schedule.

    Returns:
      ``(rows, all_counts)``: ``rows`` ``(p, p, cap)``, every rank's
      stack of all p blocks in rank order with their padding;
      ``all_counts`` ``(p, p)``, every rank's copy of the count vector.
      Across processes ``x``, ``counts`` and both results hold this
      process's ranks as rows.
    """
    p = mesh.shape[axis]
    rows = p // getattr(mesh, "procs", 1)
    if x.dim() != 2 or x.shape[0] != rows:
        raise ValueError(f"expected one (cap,) block per device: "
                         f"(p={rows}, cap) input, got {tuple(x.shape)}")
    if tuple(counts.shape) != (rows,):
        raise ValueError(f"counts must be ({rows},), got "
                         f"{tuple(counts.shape)}")
    impl = get_algorithm("allgather", algorithm)
    x, counts = x.to(mesh.device), counts.to(mesh.device)
    with on_mesh(mesh, axis):
        return impl(x, p), impl(counts[:, None], p)[..., 0]


def all_to_all_v(x: torch.Tensor, send_counts: torch.Tensor, mesh,
                 axis: str = DEFAULT_AXIS, capacity: int | None = None,
                 algorithm: str = "xla"):
    """Variable-count exchange (``MPI_Alltoallv``).

    Args:
      x: ``(p, L)``. Rank d's row holds p contiguous segments ordered
        by destination: segment j spans
        ``[cumsum(counts)[j-1], cumsum(counts)[j])``.
      send_counts: ``(p, p)`` int32; ``send_counts[d, j]`` = elements
        rank d sends to rank j.
      capacity: static per-pair row capacity (default ``L``, always
        safe). Smaller capacities cut wire volume; overflow is
        reported, not truncated silently.
      algorithm: any registered ``alltoall`` schedule.

    Returns:
      ``(rows, recv_counts, overflow)``: ``rows`` ``(p, p, capacity)``,
      row ``[d, s]`` the segment source s sent to rank d,
      sentinel-padded past ``recv_counts[d, s]``; ``overflow`` ``(p,)``,
      nonzero when some segment exceeded ``capacity`` and was truncated.
      Across processes the leading dim of ``x``, ``send_counts`` and
      each result is this process's ranks.
    """
    p = mesh.shape[axis]
    cap = int(capacity if capacity is not None else x.shape[1])
    x, counts = x.to(mesh.device), send_counts.to(mesh.device)
    ends = torch.cumsum(counts, -1, dtype=counts.dtype)
    starts = ends - counts
    with on_mesh(mesh, axis):
        return ragged_all_to_all(x, starts, counts, cap, p, algorithm)
