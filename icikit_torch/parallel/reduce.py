"""Reduce-to-root algorithm family, rank-vectorised.

The vendor collective that closes every timing loop of the reference,
``MPI_Reduce(MPI_MAX -> rank 0)`` (``Communication/src/main.cc:445``,
``Parallel-Sorting/src/psort.cc:652``), as a family: the hand-rolled
binomial-tree schedule of ``icikit.parallel.reduce`` over the rank axis,
and the vendor baseline under JAX's name ``xla`` (there the all-reduce
then the root mask; here PyTorch's own reduction over the rank axis,
written to root's row).

Contract: rank ``root`` ends with the full reduction; every other rank
ends with zeros. Trees run in relative-rank space
``rr = (r - root) mod p`` so any root works.
"""

from __future__ import annotations

import math

import torch

from icikit_torch.parallel import transport
from icikit_torch.parallel.shmap import (
    COMBINE,
    my_ranks,
    rank_where,
    reduce_ranks,
    run_collective,
)
from icikit_torch.utils.mesh import DEFAULT_AXIS
from icikit_torch.utils.registry import register_algorithm


@register_algorithm("reduce", "binomial")
def _binomial(x: torch.Tensor, p: int, op: str, root: int) -> torch.Tensor:
    """ceil(log2 p) halving rounds: in round i, relative ranks with
    ``rr % 2^(i+1) == 2^i`` send their partial to ``rr - 2^i``, which
    combines. Works for any p (a rank has no partner in rounds past its
    subtree)."""
    combine = COMBINE[op]
    rr = [(r - root) % p for r in range(p)]
    cur = x
    for i in range(max(0, math.ceil(math.log2(p))) if p > 1 else 0):
        step = 1 << i
        perm = [((root + j) % p, (root + j - step) % p)
                for j in range(step, p, 2 * step)]
        if not perm:
            break
        recv = transport.ppermute(cur, perm)
        # a receiver combines only if its sender exists (rr + step < p)
        is_recv = [q % (2 * step) == 0 and q + step < p for q in rr]
        cur = rank_where(is_recv, combine(cur, recv), cur)
    return rank_where([r == root for r in range(p)], cur, 0)


@register_algorithm("reduce", "xla")
def _xla(x: torch.Tensor, p: int, op: str, root: int) -> torch.Tensor:
    """Vendor baseline: the reduction over the rank axis into root's
    row, zeros elsewhere (across processes every process takes part in
    the backend's all-reduce; root's process keeps it)."""
    out = torch.zeros_like(x, memory_format=torch.contiguous_format)
    red = reduce_ranks(x, op)
    mine = my_ranks(p)
    if root in mine:
        out[root - mine.start] = red
    return out


REDUCE_ALGORITHMS = ("binomial", "xla")


def reduce_to_root(x: torch.Tensor, mesh, axis: str = DEFAULT_AXIS,
                   algorithm: str = "binomial", op: str = "sum",
                   root: int = 0) -> torch.Tensor:
    """Rooted reduction (``MPI_Reduce``, ``main.cc:445``).

    Args:
      x: ``(p, ...)``; rank d contributes ``x[d]``.

    Returns:
      The same shape; ``out[root]`` holds the elementwise ``op``
      reduction of every contribution, all other rows are zero.
    """
    return run_collective("reduce", algorithm, mesh, axis, x, op, root)
