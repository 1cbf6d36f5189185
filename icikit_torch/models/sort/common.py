"""Shared plumbing for the distributed sorts: padding and blocking, the
capacity-padded ragged exchange, and the rebalance to equal blocks.

The reference's ragged exchanges (``MPI_Alltoallv`` in sample sort,
``psort.cc:277``; variable ``MPI_Send/Recv`` + ``MPI_Get_count`` in
quicksort, ``:440-482``) become fixed-capacity rows plus explicit count
vectors, with overflow detected and surfaced rather than silently
truncated (``icikit_torch.parallel.alltoallv``). Every function here
takes all p ranks at once on a leading rank axis, or under a process
view (``parallel.shmap.on_mesh``) this process's ranks.
"""

from __future__ import annotations

import torch

# The ragged-exchange primitives live in the collective layer; the sorts
# use them through these names, on the "xla" carrier they default to.
from icikit_torch.parallel.alltoallv import (  # noqa: F401
    exchange_counts,
    pack_segments,
    ragged_all_to_all,
    ragged_payload,
    unpack_rows,
)
from icikit_torch.parallel.shmap import gather_ranks, rank_ids
from icikit_torch.utils.dtypes import sentinel_for
from icikit_torch.utils.mesh import (DEFAULT_AXIS, RankMesh, mesh_axis_size,
                                     shard_along)

# Capacity retries taken since the last reset: "sample" counts the
# sample family's (and the KV sort's) rerun at the safe capacity,
# "quicksort" each doubling of quicksort's capacity.
RETRIES = {"sample": 0, "quicksort": 0}


def reset_retries() -> None:
    for k in RETRIES:
        RETRIES[k] = 0


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

    Across processes ``x`` is this process's part, which must fill its
    k ranks with equal blocks (a power of two with ``pow2_local``): no
    padding, which would sort to the global tail, is added in the middle
    of the global sequence. Returns ((k, n_loc), n_loc).
    """
    p = mesh_axis_size(mesh, axis)
    n = x.shape[0]
    procs = getattr(mesh, "procs", 1)
    if procs > 1:
        k = p // procs
        n_loc = n // k if n % k == 0 else 0
        if n_loc == 0 or (pow2_local and n_loc != next_pow2(n_loc)):
            raise ValueError(
                f"across processes each process's part must fill its {k} "
                f"ranks with equal blocks"
                f"{' of a power-of-two length' if pow2_local else ''}; "
                f"got {n} elements")
        return x.to(mesh.device).reshape(k, n_loc), n_loc
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


def rebalance_sorted(flat: torch.Tensor, count: torch.Tensor, n_loc: int,
                     p: int, values: torch.Tensor | None = None):
    """Redistribute globally-sorted-but-ragged data to exactly ``n_loc``
    a rank, preserving order.

    ``flat`` (p, L): row r sorted ascending with ``count[r]`` valid
    elements (sentinel tail); the valid runs concatenated in rank order
    are sorted. Returns (p, n_loc): rank k ends with global positions
    [k*n_loc, (k+1)*n_loc), padded with sentinels past the global total.
    With ``values`` (same shape as ``flat``, payload lanes paired with
    the keys) the same routing applies to it and ``(keys, values)`` is
    returned, values zero past the total: the KV form. Under a process
    view the rows are this process's ranks.

    The regular-shape answer to the reference's "local sizes change"
    (``psort.cc:274``): one more capacity-padded all-to-all instead of
    leaving ragged results in place. The counts cross as JAX's do, one
    int32 a rank by an all-gather (``shmap.gather_ranks``).
    """
    rows_n = flat.shape[0]
    all_counts = gather_ranks(count.to(torch.int32)[:, None])[:, 0]
    all_counts = all_counts.to(torch.int64)
    offsets = torch.cumsum(all_counts, 0) - all_counts  # each run's start
    mine = rank_ids(p, flat.device)
    my_off, count = offsets[mine], count.to(torch.int64)
    d_idx = torch.arange(p, device=flat.device)
    # piece for dest d: my elements whose global position lands in
    # [d*n_loc, (d+1)*n_loc), contiguous because my run is
    seg_lo = torch.minimum((d_idx * n_loc)[None] - my_off[:, None],
                           count[:, None]).clamp_min(0)
    seg_hi = torch.minimum(((d_idx + 1) * n_loc)[None] - my_off[:, None],
                           count[:, None]).clamp_min(0)
    starts = seg_lo.to(torch.int32)
    counts = (seg_hi - seg_lo).to(torch.int32)
    # a piece inside [k*n_loc, (k+1)*n_loc) cannot exceed n_loc
    rows, recv_counts, _ = ragged_all_to_all(flat, starts, counts, n_loc, p)
    # piece from source s starts at global position max(offsets[s],
    # k*n_loc); its local offset is that less k*n_loc
    base = mine * n_loc
    piece_off = (offsets[None] - base[:, None]).clamp(0, n_loc)
    piece_end = (piece_off + recv_counts).contiguous()
    t = torch.arange(n_loc, device=flat.device)
    # the source covering t: pieces tile [0, n_loc) in source order
    s_of_t = torch.searchsorted(
        piece_end, t.expand(rows_n, n_loc).contiguous(),
        right=True).clamp_max(p - 1)
    col = (t - piece_off.gather(1, s_of_t)).clamp(0, n_loc - 1)
    src = s_of_t * n_loc + col
    in_range = t[None] < piece_end[:, -1:]
    keys_out = torch.where(in_range,
                           rows.reshape(rows_n, -1).gather(1, src),
                           sentinel_for(flat.dtype))
    if values is None:
        return keys_out
    # data leg only: the keys leg exchanged the counts for these pieces
    vrows = ragged_payload(values, starts, counts, n_loc, p)
    v = vrows.reshape(rows_n, -1).gather(1, src)
    return keys_out, torch.where(in_range, v, torch.zeros_like(v))
