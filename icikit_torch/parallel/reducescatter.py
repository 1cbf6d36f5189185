"""Reduce-scatter algorithm family, rank-vectorised.

The dual of allgather that ring allreduces are built from
(``allreduce._ring``): rank d contributes a full length-m vector and
ends with chunk d (length m/p) of the elementwise reduction. Each
variant is ``icikit.parallel.reducescatter``'s schedule over the rank
axis, combining in the schedule's own order, so the port's result is
JAX's bit for bit. ``xla`` keeps JAX's name for the vendor baseline:
PyTorch's own reduction over the rank axis, then each rank's chunk.
"""

from __future__ import annotations

import torch

from icikit_torch.parallel import transport
from icikit_torch.parallel.shmap import (
    COMBINE,
    my_ranks,
    rank_half,
    rank_put_,
    rank_take,
    reduce_ranks,
    run_collective,
    shift_perm,
    xor_perm,
)
from icikit_torch.utils.mesh import (DEFAULT_AXIS, UnsupportedMeshError,
                                     ilog2, is_pow2)
from icikit_torch.utils.registry import register_algorithm


def _chunked(x: torch.Tensor, p: int) -> torch.Tensor:
    """Each rank's length-m vector as p chunks: (p, p, m/p, ...)."""
    m = x.shape[1]
    if m % p:
        raise ValueError(f"reduce_scatter needs m divisible by p ({m} vs {p})")
    return x.reshape((x.shape[0], p, m // p) + x.shape[2:])


@register_algorithm("reducescatter", "ring")
def _ring(x: torch.Tensor, p: int, op: str) -> torch.Tensor:
    """p-1 neighbour steps, one m/p chunk a step (bandwidth-optimal).

    Step s: rank r sends its partial of chunk (r-1-s) mod p to r+1 and
    folds the incoming partial of chunk (r-2-s) mod p into its own;
    after p-1 steps rank r holds the full reduction of chunk r.
    """
    combine = COMBINE[op]
    acc = _chunked(x, p).clone(memory_format=torch.contiguous_format)
    for s in range(p - 1):
        i_send = [(r - s + p - 1) % p for r in range(p)]
        i_recv = [(r - s + p - 2) % p for r in range(p)]
        recv = transport.ppermute(rank_take(acc, i_send, 1),
                                  shift_perm(p, 1))
        rank_put_(acc, i_recv, combine(rank_take(acc, i_recv, 1), recv))
    return rank_take(acc, range(p), 1)[:, 0]


@register_algorithm("reducescatter", "recursive_halving")
def _recursive_halving(x: torch.Tensor, p: int, op: str) -> torch.Tensor:
    """log p XOR-partner rounds, volume halving each round: round i
    (top bit first) sends the partner the half of the remaining chunks
    whose bit i is the partner's and combines the half received."""
    if not is_pow2(p):
        raise UnsupportedMeshError(
            "recursive_halving reduce-scatter requires power-of-2 p")
    combine = COMBINE[op]
    acc = _chunked(x, p)
    rows, tail = acc.shape[0], acc.shape[2:]
    for i in range(ilog2(p) - 1, -1, -1):
        mask = 1 << i
        bit = [(r >> i) & 1 for r in range(p)]
        g = acc.reshape((rows, -1, 2, mask) + tail)
        keep = rank_half(g, bit)
        send = rank_half(g, [1 - b for b in bit])
        recv = transport.ppermute(send, xor_perm(p, mask))
        acc = combine(keep, recv).reshape((rows, -1) + tail)
    return acc[:, 0]


@register_algorithm("reducescatter", "pairwise")
def _pairwise(x: torch.Tensor, p: int, op: str) -> torch.Tensor:
    """p-1 rounds of direct exchange: in round s rank r sends its partial
    of chunk (r+s) mod p to its owner and folds in its own chunk's
    partial from (r-s) mod p (the wrap-around rotation of
    ``Communication/src/main.cc:370-387`` applied to reduction)."""
    combine = COMBINE[op]
    chunks = _chunked(x, p)
    mine = rank_take(chunks, range(p), 1)
    for s in range(1, p):
        blk = rank_take(chunks, [(r + s) % p for r in range(p)], 1)
        mine = combine(mine, transport.ppermute(blk, shift_perm(p, s)))
    return mine[:, 0]


@register_algorithm("reducescatter", "xla")
def _xla(x: torch.Tensor, p: int, op: str) -> torch.Tensor:
    """Vendor baseline (JAX: ``psum_scatter``, or pmax/pmin and a
    slice): the reduction over the rank axis, rank r keeping chunk r
    (across processes the backend's all-reduce, then this process's
    chunks)."""
    mine = my_ranks(p)
    red = reduce_ranks(x, op, "reduce_scatter" if op == "sum" else None)
    out = red.reshape((p, x.shape[1] // p) + x.shape[2:])
    return out[mine.start:mine.stop]


REDUCESCATTER_ALGORITHMS = ("ring", "recursive_halving", "pairwise", "xla")


def reduce_scatter(x: torch.Tensor, mesh, axis: str = DEFAULT_AXIS,
                   algorithm: str = "xla", op: str = "sum",
                   checked: bool = False, retries: int = 2) -> torch.Tensor:
    """Reduction scattered across ranks.

    Args:
      x: ``(p, m, ...)``; rank d contributes the full vector ``x[d]``.
        ``m`` must be divisible by p.
      op: "sum", "max" or "min".
      checked: run the checksum-carrying schedule: every exchanged
        block verified at its receive step on the device, a detected
        corruption quarantined and retried at the dispatch boundary, at
        most ``retries`` times (``parallel.integrity``; hand-rolled
        schedules only, ``"xla"`` raises ``ValueError``).

    Returns:
      ``(p, m/p, ...)``: ``out[d]`` is chunk d of the elementwise
      reduction over all contributions.
    """
    p = mesh.shape[axis]
    if x.dim() < 2 or x.shape[1] % p:
        raise ValueError(
            f"reduce_scatter needs m divisible by p "
            f"(shape {tuple(x.shape)}, p={p})")
    if checked:
        from icikit_torch.parallel import integrity
        return integrity.checked_reduce_scatter(x, mesh, axis, algorithm, op=op,
                                                retries=retries)
    return run_collective("reducescatter", algorithm, mesh, axis, x, op)
