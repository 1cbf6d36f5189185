"""All-gather algorithm family, rank-vectorised.

The reference calls this collective "AllToAll": every rank broadcasts its
own block so all ranks end with all p blocks
(``Communication/src/main.cc:38-223``). Each variant is
``icikit.parallel.allgather``'s schedule with the p ranks as dim 0 of
one tensor: every exchange is one ``transport.ppermute`` over all
ranks, every rank-dependent slot write one indexed copy.

- ``naive``               — C2, ``main.cc:39-61``: p-1 independent
  rotations of the own block.
- ``ring``                — C4, ``main.cc:190-223``: p-1 shift-by-one
  steps forwarding the block just received.
- ``recursive_doubling``  — C3, ``main.cc:63-188``: log2 p XOR-partner
  rounds with message volume doubling each round; power-of-2 p only.
- ``recursive_doubling_twins`` — C3's non-power-of-2 path: the
  reference's virtual "twin" ranks (``main.cc:71-75,136-185``) as four
  partial permutations per round.
- ``xla``                 — the vendor baseline. The name is JAX's (its
  ``lax.all_gather``); here it is PyTorch's own op over the rank axis,
  ``expand`` made contiguous (each rank's copy written once).
"""

from __future__ import annotations

import operator
from functools import lru_cache, reduce

import torch

from icikit_torch.parallel import transport
from icikit_torch.parallel.shmap import (
    rank_put_,
    rank_take,
    run_collective,
    shift_perm,
    xor_perm,
)
from icikit_torch.utils.mesh import (DEFAULT_AXIS, UnsupportedMeshError,
                                     ilog2, is_pow2)
from icikit_torch.utils.registry import register_algorithm


def _own_block_first(x: torch.Tensor, p: int, slots: int) -> torch.Tensor:
    """Step (1) of the shared skeleton: each rank's own block into its
    result slot, in a (p, slots, ...) buffer."""
    out = x.new_zeros((p, slots) + x.shape[1:])
    return rank_put_(out, range(p), x[:, None])


@register_algorithm("allgather", "naive")
def _naive(x: torch.Tensor, p: int) -> torch.Tensor:
    """p-1 independent rotations of the own block (C2)."""
    out = _own_block_first(x, p, p)
    recvs = [transport.ppermute(x, shift_perm(p, i)) for i in range(1, p)]
    for i, recv in enumerate(recvs, start=1):
        rank_put_(out, [(r - i) % p for r in range(p)], recv[:, None])
    return out


@register_algorithm("allgather", "ring")
def _ring(x: torch.Tensor, p: int) -> torch.Tensor:
    """p-1 shift-by-one steps, forwarding what was just received (C4)."""
    out = _own_block_first(x, p, p)
    cur = x
    for i in range(1, p):
        cur = transport.ppermute(cur, shift_perm(p, 1))
        rank_put_(out, [(r - i) % p for r in range(p)], cur[:, None])
    return out


@register_algorithm("allgather", "recursive_doubling")
def _recursive_doubling(x: torch.Tensor, p: int) -> torch.Tensor:
    """log2 p XOR-partner rounds, volume doubling each round (C3): after
    round i each rank holds the 2^(i+1)-aligned group of blocks holding
    its own rank, so a round is one slice, exchange and update."""
    if not is_pow2(p):
        raise UnsupportedMeshError(
            "recursive_doubling requires a power-of-2 device count "
            f"(got {p}); use 'recursive_doubling_twins' (the reference's "
            "virtual-twin workaround, Communication/src/main.cc:71-75), "
            "'ring', or 'naive' for other sizes")
    out = _own_block_first(x, p, p)
    for i in range(ilog2(p)):
        step = 1 << i
        base = [(r >> i) << i for r in range(p)]
        recv = transport.ppermute(rank_take(out, base, step),
                                  xor_perm(p, step))
        rank_put_(out, [b ^ step for b in base], recv)
    return out


@lru_cache(maxsize=None)
def _twin_perms(p: int, step: int) -> dict:
    """Routing tables of one twin round: virtual id v exchanges its
    aligned group with v ^ step; the owner of id v is v if v < p, else
    v - p (whose twin buffer holds it)."""
    n_twins = (1 << p.bit_length()) - p
    perms = {("own", "own"): [], ("own", "twin"): [],
             ("twin", "own"): [], ("twin", "twin"): []}
    for src_dev in range(p):
        u = src_dev ^ step
        perms[("own", "own" if u < p else "twin")].append(
            (src_dev, u if u < p else u - p))
    for src_dev in range(n_twins):
        u = (src_dev + p) ^ step
        perms[("twin", "own" if u < p else "twin")].append(
            (src_dev, u if u < p else u - p))
    return {k: tuple(v) for k, v in perms.items()}


@register_algorithm("allgather", "recursive_doubling_twins")
def _recursive_doubling_twins(x: torch.Tensor, p: int) -> torch.Tensor:
    """Recursive doubling for *any* p via virtual twin ranks (C3's
    non-power-of-2 handling, ``Communication/src/main.cc:71-75,136-185``).

    The rank count is rounded up to p2 = 2^ceil(log2 p); rank d plays
    virtual id d and, when d < p2 - p, virtual id d + p, with one
    accumulation buffer for each. Every round is four partial
    permutations routing each virtual id's aligned group to the rank
    that owns its XOR partner; virtual blocks >= p hold zeros and are
    dropped at the end.
    """
    if is_pow2(p):
        return _recursive_doubling(x, p)
    p2 = 1 << p.bit_length()
    n_twins = p2 - p
    out_own = _own_block_first(x, p, p2)
    out_twin = x.new_zeros((p, p2) + x.shape[1:])
    for i in range(ilog2(p2)):
        step = 1 << i
        perms = _twin_perms(p, step)
        base_own = [(r >> i) << i for r in range(p)]
        base_twin = [((r + p) >> i) << i for r in range(p)]
        chunks = {"own": rank_take(out_own, base_own, step),
                  "twin": rank_take(out_twin, base_twin, step)}
        # each virtual id has one partner a round (XOR is an involution
        # on [0, p2)), so each buffer receives one non-zero chunk and
        # summing the partial permutes merges them, as in JAX
        recv = {dst: [transport.ppermute(chunks[src], perms[(src, dst)])
                      for src in ("own", "twin") if perms[(src, dst)]]
                for dst in ("own", "twin")}
        rank_put_(out_own, [b ^ step for b in base_own],
                  reduce(operator.add, recv["own"]))
        if n_twins and recv["twin"]:
            rank_put_(out_twin, [b ^ step for b in base_twin],
                      reduce(operator.add, recv["twin"]))
    return out_own[:, :p]


@register_algorithm("allgather", "xla")
def _xla(x: torch.Tensor, p: int) -> torch.Tensor:
    """Vendor baseline (JAX: ``lax.all_gather`` over ICI): every rank's
    copy of the (p, ...) operand, written once by ``expand``."""
    return x.unsqueeze(0).expand((p,) + x.shape).contiguous()


ALLGATHER_ALGORITHMS = ("naive", "ring", "recursive_doubling",
                        "recursive_doubling_twins", "xla")


def all_gather_blocks(x: torch.Tensor, mesh, axis: str = DEFAULT_AXIS,
                      algorithm: str = "ring", checked: bool = False,
                      retries: int = 2) -> torch.Tensor:
    """Allgather of the rank-sharded ``x``.

    Args:
      x: ``(p, ...)``; row d is rank d's block.
      algorithm: one of ``ALLGATHER_ALGORITHMS``.
      checked: run the checksum-carrying schedule: every exchanged
        block verified at its receive step on the device, a detected
        corruption quarantined and retried at the dispatch boundary, at
        most ``retries`` times (``parallel.integrity``; hand-rolled
        schedules only, ``"xla"`` raises ``ValueError``).

    Returns:
      ``(p, p, ...)``: ``out[d]`` is rank d's assembled copy of all p
      blocks (the reference's per-rank recv buffer,
      ``Communication/src/main.cc:405-407``).
    """
    if checked:
        from icikit_torch.parallel import integrity
        return integrity.checked_all_gather(x, mesh, axis, algorithm, retries=retries)
    return run_collective("allgather", algorithm, mesh, axis, x)
