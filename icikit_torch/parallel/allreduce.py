"""All-reduce algorithm family (the north-star target, BASELINE.md),
rank-vectorised.

Hand-rolled recursive-doubling and ring (reduce-scatter + allgather)
schedules, each ``icikit.parallel.allreduce``'s over the rank axis and
bitwise equal to it, beside the vendor baseline. ``xla`` keeps JAX's
name (its psum/pmax/pmin over ICI); here it is PyTorch's own reduction
over the rank axis, ``sum``/``amax``/``amin`` over dim 0, written to
every rank.
"""

from __future__ import annotations

import torch

from icikit_torch.parallel import transport
from icikit_torch.parallel.shmap import (
    COMBINE,
    reduce_ranks,
    run_collective,
    xor_perm,
)
from icikit_torch.utils.mesh import (DEFAULT_AXIS, UnsupportedMeshError,
                                     ilog2, is_pow2)
from icikit_torch.utils.registry import register_algorithm


@register_algorithm("allreduce", "recursive_doubling")
def _recursive_doubling(x: torch.Tensor, p: int, op: str) -> torch.Tensor:
    """log p XOR-partner rounds, the full message each round
    (latency-optimal, bandwidth cost m log p)."""
    if not is_pow2(p):
        raise UnsupportedMeshError(
            "recursive_doubling allreduce requires power-of-2 p")
    combine = COMBINE[op]
    for i in range(ilog2(p)):
        x = combine(x, transport.ppermute(x, xor_perm(p, 1 << i)))
    return x


@register_algorithm("allreduce", "ring")
def _ring(x: torch.Tensor, p: int, op: str) -> torch.Tensor:
    """Ring reduce-scatter followed by ring allgather (bandwidth-optimal,
    2 m (p-1)/p a rank), composed from the registered schedules. A
    length not divisible by p is zero-padded: padded lanes only combine
    with padded lanes and are sliced off."""
    from icikit_torch.parallel.allgather import _ring as _allgather_ring
    from icikit_torch.parallel.reducescatter import _ring as _rs_ring
    rows, m = x.shape[0], x.shape[1]
    pad = (-m) % p
    if pad:
        x = torch.cat([x, x.new_zeros((rows, pad) + x.shape[2:])], 1)
    chunk = _rs_ring(x, p, op)              # rank r owns chunk r
    gathered = _allgather_ring(chunk, p)    # (p, p, m'/p, ...) in order
    out = gathered.reshape((rows, m + pad) + x.shape[2:])
    return out[:, :m] if pad else out


@register_algorithm("allreduce", "xla")
def _xla(x: torch.Tensor, p: int, op: str) -> torch.Tensor:
    """Vendor baseline: the reduction over the rank axis, every rank's
    copy written once."""
    return reduce_ranks(x, op).expand(x.shape).contiguous()


ALLREDUCE_ALGORITHMS = ("recursive_doubling", "ring", "xla")


def all_reduce(x: torch.Tensor, mesh, axis: str = DEFAULT_AXIS,
               algorithm: str = "xla", op: str = "sum",
               checked: bool = False, retries: int = 2) -> torch.Tensor:
    """Elementwise reduction over the ranks.

    Args:
      x: ``(p, ...)``; rank d contributes ``x[d]``.
      op: "sum", "max" or "min".
      checked: run the checksum-carrying schedule: every exchanged
        block verified at its receive step on the device, a detected
        corruption quarantined and retried at the dispatch boundary, at
        most ``retries`` times (``parallel.integrity``; hand-rolled
        schedules only, ``"xla"`` raises ``ValueError``).

    Returns:
      The same shape, ``out[d]`` the full reduction on every rank.
    """
    if checked:
        from icikit_torch.parallel import integrity
        return integrity.checked_all_reduce(x, mesh, axis, algorithm, op=op,
                                            retries=retries)
    return run_collective("allreduce", algorithm, mesh, axis, x, op)
