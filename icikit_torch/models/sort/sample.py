"""Distributed sample sort and the sample-bitonic hybrid.

Reference: ``parallel_sample_native_sort`` (``Parallel-Sorting/src/
psort.cc:203-291``): local sort, p-1 evenly spaced local samples,
allgather all p(p-1) samples, every rank sorts the sample set and picks
global splitters, histogram into p buckets, ``MPI_Alltoall`` counts,
``MPI_Alltoallv`` redistribute, final local sort. The hybrid
(``parallel_sample_bitonic_sort``, ``:293-375``) replaces the serial
p(p-1) sample sort with a distributed bitonic sort of the samples and
an allgather of per-rank medians.

As in ``icikit.models.sort.sample``: the ragged ``Alltoallv`` is the
capacity-padded exchange with count vectors and overflow detection
(``common.ragged_all_to_all``), and the ragged post-exchange sizes are
rebalanced to equal blocks (``common.rebalance_sorted``). Here the p
ranks are dim 0 of one tensor: an allgather is the rank axis itself,
the local sorts sort every rank's row in the same launches
(``ops.cuda_sort.local_sort``, the network for rows of at least
``MIN_KERNEL`` keys), and bucket bounds are one batched
``searchsorted``. uint32 keys ride as their order-preserving int32
image. Float keys: NaN order follows the network's min/max (the study's
keys hold none); -0.0 and 0.0 compare equal, so values agree and bits
may not.

Across processes (a mesh split over ``torch.distributed`` processes)
each process holds its ranks' rows and runs them in the same launches:
the samples (or the bitonic splitter's medians) and the rebalance's
counts cross by the backend's all-gather (``shmap.gather_ranks``), the
ragged exchange by the ``xla`` alltoall's all-to-all, and the overflow
flag is summed over the processes, so every process takes the capacity
retry together.
"""

from __future__ import annotations

import torch

from icikit_torch.models.sort.bitonic import bitonic_sort_shard
from icikit_torch.models.sort.common import (RETRIES, ragged_all_to_all,
                                             rebalance_sorted, unpack_rows)
from icikit_torch.ops.cuda_sort import _i32_as_u32, _u32_as_i32, local_sort
from icikit_torch.parallel.shmap import gather_ranks, on_mesh
from icikit_torch.utils.mesh import DEFAULT_AXIS


def _splitters_allgather(samples: torch.Tensor, p: int) -> torch.Tensor:
    """C15 splitter selection: every rank sorts all p(p-1) samples and
    picks p-1 evenly spaced global splitters (psort.cc:221-234, with the
    stride defect fixed). ``samples`` (p, p-1), gathered from every
    rank; returns (p-1,), the same for every rank."""
    s = torch.sort(gather_ranks(samples).reshape(-1)).values
    idx = (torch.arange(1, p, device=s.device) * s.shape[0]) // p
    return s[idx]


def _splitters_bitonic(samples: torch.Tensor, p: int) -> torch.Tensor:
    """C16 splitter selection: bitonic-sort the sample set across the
    ranks (each holds one length-(p-1) vector), then gather each rank's
    median (psort.cc:312-317)."""
    sorted_block = bitonic_sort_shard(samples, p)
    meds = gather_ranks(sorted_block[:, (sorted_block.shape[1] - 1) // 2])
    return meds[:-1]


def bucket_route(a: torch.Tensor, p: int, splitter: str):
    """Splitter selection and bucket bounds for locally *sorted* rows
    ``a`` (p, n_loc): returns (starts, counts), each (p, p), of the p
    contiguous destination buckets of every rank.

    The routing contract of the key-only and key-value sample sorts:
    p-1 evenly spaced local samples, splitters by the chosen scheme,
    bucket bounds by binary search (the reference scans linearly,
    ``psort.cc:241-250``). ``right=False`` (JAX's ``side="left"``) sends
    every instance of a splitter-valued key to one bucket, which the KV
    sort's stability rests on.
    """
    rows, n_loc = a.shape
    samp_idx = (torch.arange(1, p, device=a.device) * n_loc) // p
    samples = a[:, samp_idx]
    if splitter == "bitonic":
        splitters = _splitters_bitonic(samples, p)
    else:
        splitters = _splitters_allgather(samples, p)
    bounds = torch.searchsorted(
        a, splitters.expand(rows, p - 1).contiguous(), right=False,
        out_int32=True)
    zero = torch.zeros((rows, 1), dtype=bounds.dtype, device=a.device)
    starts = torch.cat([zero, bounds], 1)
    ends = torch.cat([bounds, zero + n_loc], 1)
    return starts, ends - starts


def sample_sort_shard(a: torch.Tensor, p: int, cap: int, splitter: str):
    """Rank-vectorised sample sort of ``a`` (p, n_loc), or under a
    process view this process's ranks. Returns (sorted (p, n_loc),
    overflow (p,)).

    ``cap``: the per-(source, destination) bucket capacity of the padded
    exchange; a nonzero overflow means some bucket exceeded it and the
    result is invalid (the caller retries at the safe capacity n_loc).
    """
    n_loc = a.shape[1]
    a = local_sort(a)
    if p == 1:
        return a, torch.zeros(1, dtype=torch.int32, device=a.device)
    starts, counts = bucket_route(a, p, splitter)
    rows, recv_counts, overflow = ragged_all_to_all(a, starts, counts, cap,
                                                    p)
    flat, valid = unpack_rows(rows, recv_counts)
    flat = local_sort(flat)  # final local sort (:281); sentinels to tail
    return rebalance_sorted(flat, valid, n_loc, p), overflow


def run_with_capacity_retry(build, n_loc: int, p: int, cap_factor: float,
                            *operands):
    """Run a capacity-parameterized program with the standard escalation:
    start at ``cap_factor * n_loc / p`` (balanced buckets need ~n_loc/p),
    retry once at the safe capacity n_loc if any bucket overflowed.
    ``build(cap)`` returns a callable whose result tuple ends with the
    overflow flag. Each retry adds one to ``common.RETRIES["sample"]``.
    Across processes the flag is already summed over the processes
    (``ragged_all_to_all``), so every process retries or none does.

    The default ``cap_factor = 4.0`` comes from the JAX package's
    overflow study (``capacity_study.json``; ``bench.capacity`` here
    reruns it): the minimal non-overflowing factor was 1.25 for
    allgather splitters on uniform data, 2.0-3.0 under odd_dist, and
    3.0 at worst for the bitonic splitter."""
    cap = max(1, min(n_loc, int(cap_factor * n_loc / max(p, 1))))
    out = build(cap)(*operands)
    # Order matters: when cap == n_loc the retry can never fire, and the
    # overflow read makes the host wait for the card in the middle of
    # otherwise queued launches.
    if cap < n_loc and int(out[-1].sum()) > 0:
        RETRIES["sample"] += 1
        out = build(n_loc)(*operands)
    return out


# The JAX package's measured default (see run_with_capacity_retry).
DEFAULT_CAP_FACTOR = 4.0


def sample_sort_blocks(x2d: torch.Tensor, mesh, axis: str = DEFAULT_AXIS,
                       splitter: str = "allgather",
                       cap_factor: float = DEFAULT_CAP_FACTOR):
    """Sort (p, n_loc) data globally ascending (across processes,
    ``x2d`` and the result hold this process's ranks)."""
    rows, n_loc = x2d.shape
    p = mesh.shape[axis]
    if rows != p // getattr(mesh, "procs", 1):
        raise ValueError(f"leading dim {rows} != p={p}")
    if x2d.dtype == torch.uint32:
        return _i32_as_u32(sample_sort_blocks(_u32_as_i32(x2d), mesh, axis,
                                              splitter, cap_factor))
    with on_mesh(mesh, axis):
        out, _ = run_with_capacity_retry(
            lambda cap: (lambda x: sample_sort_shard(x, p, cap, splitter)),
            n_loc, p, cap_factor, x2d)
    return out
