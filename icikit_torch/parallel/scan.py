"""Prefix-reduction (scan) algorithm family, the ``MPI_Scan`` /
``MPI_Exscan`` analog, rank-vectorised.

Rank d ends with op(x[0], ..., x[d]) (inclusive) or
op(x[0], ..., x[d-1]) (exclusive). The schedules are
``icikit.parallel.scan``'s over the rank axis:

- ``hillis_steele`` — ceil(log2 p) doubling rounds; round i combines in
  the value from the rank 2^i to the left (a *partial* permutation).
- ``linear`` — p-1 shift-by-one rounds forwarding the original blocks,
  the ring schedule (``Communication/src/main.cc:190-223``) carrying
  partial prefixes.
- ``xla`` — the vendor baseline under JAX's name (there an all_gather
  and a local cumulative reduction); here PyTorch's own cumulative op
  over the rank axis (``cumsum``, ``cummax``, ``cummin``).

Exclusive scans shift the inclusive result right by one rank (rank 0
gets the op's identity), ``MPI_Exscan``'s contract.
"""

from __future__ import annotations

import torch

from icikit_torch.parallel import transport
from icikit_torch.parallel.shmap import (
    COMBINE,
    gather_ranks,
    my_ranks,
    partial_shift_perm,
    rank_where,
    register_family,
    run_collective,
)
from icikit_torch.utils.mesh import DEFAULT_AXIS
from icikit_torch.utils.registry import register_algorithm

_CUM = {"sum": lambda a: torch.cumsum(a, 0, dtype=a.dtype),
        "max": lambda a: torch.cummax(a, 0).values,
        "min": lambda a: torch.cummin(a, 0).values}


def _identity(dtype: torch.dtype, op: str):
    if op == "sum":
        return 0
    big = (torch.finfo(dtype) if dtype.is_floating_point
           else torch.iinfo(dtype))
    return big.min if op == "max" else big.max


@register_algorithm("scan", "hillis_steele")
def _hillis_steele(x: torch.Tensor, p: int, op: str) -> torch.Tensor:
    """ceil(log2 p) partial-shift rounds: round i pulls the running
    prefix from rank r - 2^i; ranks r < 2^i already hold their full
    prefix and keep it (a mask, not wraparound)."""
    combine = COMBINE[op]
    for i in range((p - 1).bit_length()):
        step = 1 << i
        recv = transport.ppermute(x, partial_shift_perm(p, step))
        x = rank_where([r >= step for r in range(p)], combine(x, recv), x)
    return x


@register_algorithm("scan", "linear")
def _linear(x: torch.Tensor, p: int, op: str) -> torch.Tensor:
    """p-1 shift-by-one rounds; after round k rank r has folded in
    x[r-k..r], each round's message the unreduced block from k ranks to
    the left."""
    combine = COMBINE[op]
    acc, cur = x, x
    perm = partial_shift_perm(p, 1)
    for k in range(1, p):
        cur = transport.ppermute(cur, perm)
        acc = rank_where([r >= k for r in range(p)], combine(acc, cur), acc)
    return acc


@register_algorithm("scan", "xla")
def _xla(x: torch.Tensor, p: int, op: str) -> torch.Tensor:
    """Vendor baseline: the cumulative op over the rank axis (across
    processes, over the rows gathered by the backend's all-gather)."""
    mine = my_ranks(p)
    return _CUM[op](gather_ranks(x))[mine.start:mine.stop]


SCAN_ALGORITHMS = ("hillis_steele", "linear", "xla")


def _adapter(impl, p: int, op: str, inclusive: bool):
    """The scan's program: the schedule, then for an exclusive scan
    (``MPI_Exscan``) a shift right by one rank, rank 0 taking the op's
    identity (JAX's adapter, whose shift a checked run verifies too)."""
    def body(x: torch.Tensor) -> torch.Tensor:
        out = impl(x, p, op)
        if inclusive:
            return out
        shifted = transport.ppermute(out, partial_shift_perm(p, 1))
        return rank_where([r == 0 for r in range(p)],
                          torch.full_like(out, _identity(out.dtype, op)),
                          shifted)
    return body


register_family("scan", _adapter)


def scan_reduce(x: torch.Tensor, mesh, axis: str = DEFAULT_AXIS,
                algorithm: str = "hillis_steele", op: str = "sum",
                inclusive: bool = True, checked: bool = False,
                retries: int = 2) -> torch.Tensor:
    """Prefix reduction over the ranks.

    Args:
      x: ``(p, ...)``; rank d contributes ``x[d]``.
      inclusive: ``True`` gives ``out[d] = op(x[0..d])`` (``MPI_Scan``);
        ``False`` gives ``out[d] = op(x[0..d-1])``, the identity at d = 0
        (``MPI_Exscan``).
      checked: run the checksum-carrying schedule: every exchanged
        block verified at its receive step on the device, a detected
        corruption quarantined and retried at the dispatch boundary, at
        most ``retries`` times (``parallel.integrity``; hand-rolled
        schedules only, ``"xla"`` raises ``ValueError``).

    Returns:
      ``(p, ...)`` with the per-rank prefix reductions.
    """
    if checked:
        from icikit_torch.parallel import integrity
        return integrity.checked_scan(x, mesh, axis, algorithm, op=op,
                                      inclusive=inclusive,
                                      retries=retries)
    return run_collective("scan", algorithm, mesh, axis, x, op,
                          bool(inclusive))
