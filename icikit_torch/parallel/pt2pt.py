"""Point-to-point primitives, rank-vectorised: the ``MPI_Send``/
``MPI_Recv``/``MPI_Sendrecv`` surface as permutation exchanges
(``icikit.parallel.pt2pt``'s).

Every hand-rolled schedule of the reference is built from point-to-point
calls with deadlock-avoidance orderings (lower-rank-sends-first,
``Communication/src/main.cc:115-132``; even/odd, ``:206-216``). A
permutation exchange needs no such discipline: each primitive here is
one ``transport.ppermute`` over the rank axis (two for the halo), so a
checked-mode ``Tracker`` and the process backend see it as they see the
families' exchanges. ``x`` is the ``(p, ...)`` operand, row r rank r's
block (across processes: this process's ranks).

A JAX call maps to the port's by dropping the per-shard view: JAX's
``send_to(b, "p", pairs)`` inside ``shard_map`` is ``send_to(x,
pairs)`` on the rank-major operand, ``sendrecv_shift(b, "p", p, s)`` is
``sendrecv_shift(x, p, s)``, ``sendrecv_xor(b, "p", p, m)`` is
``sendrecv_xor(x, p, m)``, ``halo_exchange(b, "p", p, w, periodic)`` is
``halo_exchange(x, p, w, periodic)`` with the exchanged dimension dim 1
(a block's leading dim), and ``barrier("p")`` is ``barrier(p, device)``.
The port's families keep ``axis`` only at their mesh entry points, and
these primitives have none.

No tags and no wildcard receive, as in JAX: the ``MPI_Iprobe``/
``MPI_ANY_SOURCE`` drain loop of the DLB server
(``Dynamic-Load-Balancing/src/main.cc:84-112``) is host orchestration
(``icikit_torch.models.solitaire.scheduler``).
"""

from __future__ import annotations

import torch

from icikit_torch.parallel import transport
from icikit_torch.parallel.shmap import (my_ranks, partial_shift_perm,
                                         reduce_ranks, shift_perm, xor_perm)
from icikit_torch.utils.mesh import UnsupportedMeshError, is_pow2

__all__ = ["send_to", "sendrecv_shift", "sendrecv_xor", "halo_exchange",
           "barrier", "shift_perm", "xor_perm", "partial_shift_perm"]


def send_to(x: torch.Tensor, pairs) -> torch.Tensor:
    """Targeted sends along explicit (src, dst) ``pairs`` (each src and
    dst at most once, MPI's matched-envelope rule): ``out[dst] =
    x[src]``; ranks that receive nothing get zeros."""
    return transport.ppermute(x, tuple(map(tuple, pairs)))


def sendrecv_shift(x: torch.Tensor, p: int, shift: int = 1) -> torch.Tensor:
    """``MPI_Sendrecv`` on the ring: rank r sends to ``(r + shift) mod
    p`` and receives from ``(r - shift) mod p`` (``main.cc:379-385``)."""
    return transport.ppermute(x, shift_perm(p, shift))


def sendrecv_xor(x: torch.Tensor, p: int, mask: int) -> torch.Tensor:
    """``MPI_Sendrecv`` with the hypercube partner ``r ^ mask``
    (``psort.cc:121``, ``main.cc:250``); p must be a power of 2."""
    if not is_pow2(p):
        raise UnsupportedMeshError(
            f"sendrecv_xor needs a power-of-2 device count, got {p}")
    if not 0 < mask < p:
        raise ValueError(f"mask must be in [1, {p}), got {mask}")
    return transport.ppermute(x, xor_perm(p, mask))


def halo_exchange(x: torch.Tensor, p: int, width: int,
                  periodic: bool = True):
    """Neighbour halo exchange on a 1-D Cartesian topology
    (``MPI_Neighbor_alltoall``).

    ``x`` is ``(p, block, ...)``, the exchanged dimension dim 1. Returns
    ``(left_halo, right_halo)``, each ``(p, width, ...)``: the last
    ``width`` rows of the left neighbour's block and the first ``width``
    of the right one's. Without ``periodic``, rank 0's left and rank
    p-1's right halo are zeros.
    """
    if not 0 < width <= x.shape[1]:
        raise ValueError(
            f"halo width must be in [1, block={x.shape[1]}], got {width}")
    if periodic:
        right_perm, left_perm = shift_perm(p, 1), shift_perm(p, -1)
    else:
        right_perm = partial_shift_perm(p, 1)
        left_perm = tuple((j, j - 1) for j in range(1, p))
    left_halo = transport.ppermute(x[:, -width:], right_perm)
    right_halo = transport.ppermute(x[:, :width], left_perm)
    return left_halo, right_halo


def barrier(p: int, device="cuda") -> torch.Tensor:
    """``MPI_Barrier``: a zero int32 a rank, ``(p,)`` (across processes,
    this process's ranks). It is the sum over the ranks of zeros, JAX's
    ``psum``: across processes the backend's all-reduce, which no
    process leaves before every process has entered. Consume it (add it
    to a value whose timing it should gate), as in JAX."""
    rows = len(my_ranks(p))
    zero = reduce_ranks(torch.zeros((rows,), dtype=torch.int32,
                                    device=device), "sum")
    return zero.expand(rows).contiguous()
