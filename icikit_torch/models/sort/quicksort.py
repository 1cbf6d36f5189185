"""Distributed hypercube quicksort.

Reference: ``parallel_quick_sort`` (``Parallel-Sorting/src/psort.cc:
377-490``): d = log2 p rounds; round i splits the world into 2^i
sub-communicators (``MPI_Comm_split`` by ``color = myid / 2^(d-i)``,
``:403-413``), picks a median-of-medians pivot within each sub-cube
(``:421-426``), partitions locally at ``lower_bound(pivot)`` (``:429``),
and exchanges halves across the sub-cube's top bit (``:432-482``) with
``MPI_Get_count`` sizing the variable receive. Buffers are
over-allocated to absorb skew (``:385``).

As in ``icikit.models.sort.quicksort``: no communicator splitting (a
rank's sub-cube is the aligned group of its rank bits, its medians a
slice of every rank's), a fixed-capacity exchange with explicit counts
and overflow detection (one partner a round, so one ``ppermute`` of a
packed row), and a rebalance to equal blocks
(``common.rebalance_sorted``). Here the p ranks are dim 0 of one
tensor: each round's local sort sorts all p working buffers in the same
launches (``ops.cuda_sort.local_sort``).

Validity is tracked by explicit counts, not sentinel comparison, so
keys equal to the dtype's maximum (the sentinel) sort correctly;
sentinels only keep invalid tails at the buffer end. uint32 keys ride
as their order-preserving int32 image; float keys as in
``models.sort.sample``.

Across processes (a mesh split over ``torch.distributed`` processes)
each process holds its ranks' buffers: the medians cross by the
backend's all-gather (each subcube's pivot is then computed on every
process that holds one of its ranks), a half whose partner lives in
another process by the process backend, and the overflow flag is summed
over the processes, so every process doubles the capacity together.
"""

from __future__ import annotations

import torch

from icikit_torch.models.sort.common import RETRIES, rebalance_sorted
from icikit_torch.ops.cuda_sort import _i32_as_u32, _u32_as_i32, local_sort
from icikit_torch.parallel import transport
from icikit_torch.parallel.shmap import (gather_ranks, on_mesh, rank_ids,
                                         reduce_ranks, xor_perm)
from icikit_torch.utils.dtypes import sentinel_for
from icikit_torch.utils.mesh import (DEFAULT_AXIS, UnsupportedMeshError,
                                     ilog2, is_pow2)


def hypercube_quicksort_shard(a: torch.Tensor, p: int, cap: int):
    """Rank-vectorised hypercube quicksort of ``a`` (p, n_loc), or under
    a process view this process's ranks. Returns (sorted (p, n_loc),
    overflow (p,)). ``cap`` >= n_loc is the working buffer's
    capacity."""
    if not is_pow2(p):
        raise UnsupportedMeshError(
            f"hypercube quicksort requires a power-of-2 device count "
            f"(got {p}), as in the reference (psort.cc:378-382)")
    rows, n_loc = a.shape
    dev = a.device
    if p == 1:
        return local_sort(a), torch.zeros(1, dtype=torch.int32, device=dev)
    sent = sentinel_for(a.dtype)
    r = rank_ids(p, dev)
    # working buffers: a valid prefix of count[r] elements, sentinel tail
    buf = torch.full((rows, cap), sent, dtype=a.dtype, device=dev)
    buf[:, :n_loc] = a
    count = torch.full((rows,), n_loc, dtype=torch.int64, device=dev)
    overflow = torch.zeros(rows, dtype=torch.int32, device=dev)
    t = torch.arange(cap, device=dev)

    def take(idx):
        return buf.gather(1, idx.clamp(0, cap - 1))

    for i in range(ilog2(p)):
        g = p >> i           # sub-cube size this round
        half = g >> 1
        base = (r // g) * g  # my sub-cube's first rank (the color split)
        buf = local_sort(buf)  # sentinels stay at the tail
        # median of my valid prefix, then median-of-medians in my group
        # (psort.cc:407-426); an empty prefix gives the sentinel
        my_med = take(((count - 1) // 2)[:, None])[:, 0]
        my_med = torch.where(count > 0, my_med, torch.full_like(my_med,
                                                                 sent))
        gmeds = gather_ranks(my_med)[base[:, None]
                                     + torch.arange(g, device=dev)]
        pivot = torch.sort(gmeds, dim=1).values[:, half]
        # partition at lower_bound(pivot) (:429): elements equal to the
        # pivot go to the upper half, as in the reference
        k = torch.minimum(torch.searchsorted(
            buf, pivot[:, None].contiguous(), right=False)[:, 0], count)
        in_low = (r & half) == 0
        # the low side keeps [0, k) and ships [k, count); the high side
        # ships [0, k) and keeps [k, count) (:440-482)
        send_start = torch.where(in_low, k, 0)
        send_count = torch.where(in_low, count - k, k)
        keep_start = torch.where(in_low, 0, k)
        keep_count = torch.where(in_low, k, count - k)
        seg = torch.where(t < send_count[:, None],
                          take(send_start[:, None] + t), sent)
        perm = xor_perm(p, half)
        recv = transport.ppermute(seg, perm)
        recv_count = transport.ppermute(send_count.to(torch.int32),
                                        perm).to(torch.int64)
        new_count = keep_count + recv_count
        overflow |= (new_count > cap).to(torch.int32)
        recv_used = torch.minimum(recv_count, cap - keep_count)
        kept = take(keep_start[:, None] + t)
        got = recv.gather(1, (t - keep_count[:, None]).clamp(0, cap - 1))
        kc = keep_count[:, None]
        buf = torch.where(t < kc, kept,
                          torch.where(t < kc + recv_used[:, None], got,
                                      sent))
        count = new_count.clamp_max(cap)
    buf = local_sort(buf)  # final local sort (:486)
    overflow = reduce_ranks(overflow, "sum").expand(rows)
    return rebalance_sorted(buf, count, n_loc, p), overflow


# The JAX package's measured default (see hypercube_quicksort_blocks).
DEFAULT_CAP_FACTOR = 2.0


def hypercube_quicksort_blocks(x2d: torch.Tensor, mesh,
                               axis: str = DEFAULT_AXIS,
                               cap_factor: float = DEFAULT_CAP_FACTOR,
                               max_cap_factor: float = 8.0):
    """Sort (p, n_loc) data globally ascending (across processes,
    ``x2d`` and the result hold this process's ranks).

    The working capacity starts at ``cap_factor * n_loc`` (the
    reference over-allocated to n in all, ``psort.cc:385``) and doubles
    on detected overflow up to ``max_cap_factor`` (each doubling adds
    one to ``common.RETRIES["quicksort"]``); past that a RuntimeError
    reports irreducible skew. The default 2.0 is the JAX package's
    measured one: median-of-medians pivots keep each round's split so
    even that 1.25 n_loc sufficed under uniform and odd_dist keys at p
    in {4, 8}, n in {2^20, 2^22} (``capacity_study.json``).
    """
    rows, n_loc = x2d.shape
    p = mesh.shape[axis]
    if rows != p // getattr(mesh, "procs", 1):
        raise ValueError(f"leading dim {rows} != p={p}")
    if x2d.dtype == torch.uint32:
        return _i32_as_u32(hypercube_quicksort_blocks(
            _u32_as_i32(x2d), mesh, axis, cap_factor, max_cap_factor))
    if p == 1:
        # a local sort, which cannot overflow: no overflow read
        return hypercube_quicksort_shard(x2d, p, n_loc)[0]
    f = cap_factor
    while True:
        cap = int(f * n_loc)
        with on_mesh(mesh, axis):
            out, overflow = hypercube_quicksort_shard(x2d, p, cap)
        if int(overflow.sum()) == 0:
            return out
        f *= 2
        if f > max_cap_factor:
            raise RuntimeError(
                f"hypercube quicksort overflowed capacity {cap} "
                f"(cap_factor {f / 2}); data skew exceeds max_cap_factor="
                f"{max_cap_factor}: raise it or use sample sort")
        RETRIES["quicksort"] += 1
