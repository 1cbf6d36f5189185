"""All-to-all (personalized) algorithm family, the distributed
transpose, rank-vectorised.

The reference's "AllToAllPersonalized" (``Communication/src/main.cc:234-388``):
rank i holds p distinct blocks and sends block j to rank j. Each variant
is ``icikit.parallel.alltoall``'s schedule over the rank axis:

- ``wraparound`` — C8, ``main.cc:370-387``: p-1 rotation steps; step i
  sends block (r+i) mod p to that rank.
- ``naive``      — C7, ``main.cc:342-368``: the same peer pattern posted
  all at once.
- ``ecube``      — C5, ``main.cc:237-263``: p-1 XOR-partner exchange
  steps (partner ``r ^ i``), power-of-2 only.
- ``hypercube``  — C6, ``main.cc:265-340``: log p rounds exchanging the
  p/2 blocks whose destination's bit i differs from the rank's, as a
  bit-axis swap of the p-slot buffer.
- ``xla``        — the vendor baseline. The name is JAX's (its
  ``lax.all_to_all``); here it is PyTorch's ``transpose`` of the rank
  and slot axes, made contiguous.
"""

from __future__ import annotations

import torch

from icikit_torch.parallel import transport
from icikit_torch.parallel.shmap import (
    rank_put_,
    rank_take,
    run_collective,
    shift_perm,
    xor_perm,
)
from icikit_torch.parallel.transport import index
from icikit_torch.utils.mesh import (DEFAULT_AXIS, UnsupportedMeshError,
                                     ilog2, is_pow2)
from icikit_torch.utils.registry import register_algorithm


def _require_pow2(name: str, p: int):
    if not is_pow2(p):
        raise UnsupportedMeshError(
            f"{name} all-to-all requires a power-of-2 device count (got "
            f"{p}); use 'wraparound', 'naive', or 'xla' for other sizes")


def _own_slot(buf: torch.Tensor, p: int) -> torch.Tensor:
    """A zeroed output with each rank's own block in its own slot."""
    out = torch.zeros_like(buf, memory_format=torch.contiguous_format)
    return rank_put_(out, range(p), rank_take(buf, range(p), 1))


@register_algorithm("alltoall", "wraparound")
def _wraparound(buf: torch.Tensor, p: int) -> torch.Tensor:
    """p-1 rotation steps, sequentially accumulated (C8)."""
    out = _own_slot(buf, p)
    for i in range(1, p):
        send = rank_take(buf, [(r + i) % p for r in range(p)], 1)
        recv = transport.ppermute(send, shift_perm(p, i))
        rank_put_(out, [(r - i) % p for r in range(p)], recv)
    return out


@register_algorithm("alltoall", "naive")
def _naive(buf: torch.Tensor, p: int) -> torch.Tensor:
    """The same peer pattern as wraparound, posted as independent
    exchanges (C7)."""
    out = _own_slot(buf, p)
    recvs = [transport.ppermute(
        rank_take(buf, [(r + i) % p for r in range(p)], 1), shift_perm(p, i))
        for i in range(1, p)]
    for i, recv in enumerate(recvs, start=1):
        rank_put_(out, [(r - i) % p for r in range(p)], recv)
    return out


@register_algorithm("alltoall", "ecube")
def _ecube(buf: torch.Tensor, p: int) -> torch.Tensor:
    """p-1 XOR-partner direct exchanges (C5)."""
    _require_pow2("ecube", p)
    out = _own_slot(buf, p)
    for i in range(1, p):
        partner = [r ^ i for r in range(p)]
        recv = transport.ppermute(rank_take(buf, partner, 1), xor_perm(p, i))
        rank_put_(out, partner, recv)
    return out


@register_algorithm("alltoall", "hypercube")
def _hypercube(buf: torch.Tensor, p: int) -> torch.Tensor:
    """log p rounds, p/2 blocks a round: store-and-forward routing (C6).

    After round i, slot d of every rank holds a block whose destination
    agrees with the rank on bits 0..i; at the end slot s of rank r holds
    the block src s sent to dst r. Round i views the slots with bit i as
    its own axis and swaps the half whose bit differs from the rank's
    (``my_bit``) with partner ``r ^ 2^i``.
    """
    _require_pow2("hypercube", p)
    out = buf.clone(memory_format=torch.contiguous_format)
    tail = buf.shape[2:]
    ranks = index(tuple(range(p)), buf.device)
    for i in range(ilog2(p)):
        bit = 1 << i
        view = out.view((p, p // (2 * bit), 2, bit) + tail)
        other = index(tuple(1 - ((r >> i) & 1) for r in range(p)),
                      buf.device)
        recv = transport.ppermute(view[ranks, :, other], xor_perm(p, bit))
        view[ranks, :, other] = recv
    return out


@register_algorithm("alltoall", "xla")
def _xla(buf: torch.Tensor, p: int) -> torch.Tensor:
    """Vendor baseline: the transpose of the rank and slot axes."""
    del p
    return buf.transpose(0, 1).contiguous()


ALLTOALL_ALGORITHMS = ("wraparound", "naive", "ecube", "hypercube", "xla")


def all_to_all_blocks(x: torch.Tensor, mesh, axis: str = DEFAULT_AXIS,
                      algorithm: str = "wraparound", checked: bool = False,
                      retries: int = 2) -> torch.Tensor:
    """Distributed transpose of per-destination blocks.

    Args:
      x: ``(p, p, ...)``; rank s owns row ``x[s]``, whose slot d is the
        block destined for rank d.
      checked: run the checksum-carrying schedule: every exchanged
        block verified at its receive step on the device, a detected
        corruption quarantined and retried at the dispatch boundary, at
        most ``retries`` times (``parallel.integrity``; hand-rolled
        schedules only, ``"xla"`` raises ``ValueError``).

    Returns:
      ``swapaxes(x, 0, 1)``: rank d ends with ``out[d, s] = x[s, d]``,
      the reference's verification condition
      (``Communication/src/main.cc:478-486``).
    """
    if checked:
        from icikit_torch.parallel import integrity
        return integrity.checked_all_to_all(x, mesh, axis, algorithm, retries=retries)
    return run_collective("alltoall", algorithm, mesh, axis, x)
