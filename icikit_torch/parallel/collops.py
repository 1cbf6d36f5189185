"""Broadcast / scatter / gather algorithm families (north-star sweep,
BASELINE.md: "broadcast + scatter/gather bandwidth sweep 1KB-64MB"),
rank-vectorised.

Hand-rolled linear, ring and binomial-tree schedules built from
``transport.ppermute`` (partial permutations included, the analog of
targeted ``MPI_Send``), each ``icikit.parallel.collops``'s over the rank
axis. The binomial trees run in *relative-rank* space
``rr = (r - root) mod p`` so any root works with the same static
schedule. The ``xla`` variants keep JAX's name for the vendor baseline;
here each is PyTorch's own op over the rank axis (``expand`` of root's
block, a copy of root's buffer, ``expand`` of all blocks), and across
processes the backend's broadcast or all-gather.

Across processes (``shmap.run_collective`` under a process view) a body
holds this process's ranks as rows: scatter's operand is still the whole
buffer, which every process holds, and only root's process reads it.
"""

from __future__ import annotations

import math

import torch

from icikit_torch.parallel import transport
from icikit_torch.parallel.shmap import (
    gather_ranks,
    my_ranks,
    rank_put_,
    rank_take,
    rank_where,
    run_collective,
    shift_perm,
)
from icikit_torch.utils.mesh import DEFAULT_AXIS, UnsupportedMeshError, is_pow2
from icikit_torch.utils.registry import register_algorithm


def _is(p: int, rank: int):
    return [r == rank for r in range(p)]


def _rel(p: int, root: int):
    return [(r - root) % p for r in range(p)]


# ---------------------------------------------------------------------------
# broadcast: root's block -> every rank
# ---------------------------------------------------------------------------


@register_algorithm("broadcast", "ring")
def _bcast_ring(x, p, root):
    """p-1 shift-by-one steps; rank root+k receives the payload at step k."""
    is_root = _is(p, root)
    cur = rank_where(is_root, x, 0)
    for _ in range(p - 1):
        recv = transport.ppermute(cur, shift_perm(p, 1))
        cur = rank_where(is_root, cur, recv)
    return cur


@register_algorithm("broadcast", "binomial")
def _bcast_binomial(x, p, root):
    """ceil(log2 p) doubling rounds: holders rr < 2^i send to rr + 2^i."""
    rr = _rel(p, root)
    cur = rank_where(_is(p, root), x, 0)
    for i in range(max(1, math.ceil(math.log2(p))) if p > 1 else 0):
        step = 1 << i
        perm = [((root + j) % p, (root + j + step) % p)
                for j in range(step) if j + step < p]
        if not perm:
            break
        recv = transport.ppermute(cur, perm)
        cur = rank_where([step <= q < min(p, 2 * step) for q in rr],
                         recv, cur)
    return cur


@register_algorithm("broadcast", "xla")
def _bcast_xla(x, p, root):
    """Vendor baseline (JAX: a masked psum): root's block written to
    every rank by ``expand`` (across processes, by the backend's
    broadcast from root's process)."""
    view = transport.process_view()
    if view is None:
        block = x[root:root + 1]
    else:
        mine = my_ranks(p)
        block = view.broadcast(
            x[root - mine.start:root - mine.start + 1] if root in mine
            else x.new_empty((1,) + x.shape[1:]), root)
    out = block.expand(x.shape).contiguous()
    return transport.vendor("psum", x, out)


BROADCAST_ALGORITHMS = ("ring", "binomial", "xla")


def broadcast(x: torch.Tensor, mesh, axis: str = DEFAULT_AXIS,
              algorithm: str = "binomial", root: int = 0) -> torch.Tensor:
    """Broadcast rank ``root``'s block to all ranks.

    ``x``: ``(p, ...)``. Returns the same shape with ``out[d] = x[root]``
    for every d.
    """
    return run_collective("broadcast", algorithm, mesh, axis, x, root)


# ---------------------------------------------------------------------------
# scatter: root holds p blocks -> rank d gets block d
# ---------------------------------------------------------------------------


def _everyone(block: torch.Tensor, p: int) -> torch.Tensor:
    """The same buffer seen by every rank this process holds, as a
    (rows, ...) view."""
    return block.unsqueeze(0).expand((len(my_ranks(p)),) + block.shape)


@register_algorithm("scatter", "linear")
def _scatter_linear(buf, p, root):
    """Root sends each block directly via a partial permutation (the
    targeted-``MPI_Send`` analog)."""
    out = rank_where(_is(p, root), _everyone(buf[root], p), 0)
    for j in range(1, p):
        d = (root + j) % p
        recv = transport.ppermute(_everyone(buf[d], p), [(root, d)])
        out = rank_where(_is(p, d), recv, out)
    return out


@register_algorithm("scatter", "binomial")
def _scatter_binomial(buf, p, root):
    """Halving binomial tree: log p rounds, message size halves each round."""
    if not is_pow2(p):
        raise UnsupportedMeshError("binomial scatter requires power-of-2 p")
    rr = _rel(p, root)
    # relative block order: rel[k] = block for rank (root+k)%p, held by
    # root alone at the start
    mine = my_ranks(p)
    rel = buf.new_zeros((len(mine),) + buf.shape)
    if root in mine:
        rel[root - mine.start] = torch.roll(buf, -root, 0)
    half = p // 2
    while half >= 1:
        seg = rank_take(rel, [(q + half) % p for q in rr], half)
        perm = [((root + j) % p, (root + j + half) % p)
                for j in range(0, p, 2 * half)]
        recv = transport.ppermute(seg, perm)
        mine = rank_take(rel, rr, half)
        rank_put_(rel, rr, rank_where([q % (2 * half) == half for q in rr],
                                      recv, mine))
        half //= 2
    return rank_take(rel, rr, 1)[:, 0]


@register_algorithm("scatter", "xla")
def _scatter_xla(buf, p, root):
    """Vendor baseline (JAX: root's buffer broadcast by a masked psum,
    each rank slicing its block): root's buffer copied out, row d to
    rank d (across processes, broadcast from root's process by the
    backend, each process keeping its ranks' rows)."""
    view = transport.process_view()
    if view is None:
        out = buf.clone(memory_format=torch.contiguous_format)
    else:
        mine = my_ranks(p)
        out = view.broadcast(buf, root)[mine.start:mine.stop].contiguous()
    return transport.vendor("psum", buf, out,
                            buf.numel() * buf.element_size())


SCATTER_ALGORITHMS = ("linear", "binomial", "xla")


def scatter_blocks(x: torch.Tensor, mesh, axis: str = DEFAULT_AXIS,
                   algorithm: str = "binomial", root: int = 0) -> torch.Tensor:
    """Scatter root's ``(p, ...)`` buffer: rank d receives block d.

    ``x``: ``(p, ...)``, one buffer every rank sees
    (``utils.mesh.replicate``; only root's view is read). Returns
    ``(p, ...)`` with ``out[d] = x[d]``.
    """
    return run_collective("scatter", algorithm, mesh, axis, x, root)


# ---------------------------------------------------------------------------
# gather: rank blocks -> root holds all p blocks
# ---------------------------------------------------------------------------


@register_algorithm("gather", "linear")
def _gather_linear(x, p, root):
    """Each rank sends its block straight to root (partial perms). As in
    JAX, every rank's buffer starts with its own block in slot root."""
    buf = x.new_zeros((x.shape[0], p) + x.shape[1:])
    buf[:, root] = x
    for j in range(1, p):
        d = (root + j) % p
        buf[:, d] = transport.ppermute(x, [(d, root)])
    return buf


@register_algorithm("gather", "binomial")
def _gather_binomial(x, p, root):
    """Doubling binomial tree: the reverse of binomial scatter."""
    if not is_pow2(p):
        raise UnsupportedMeshError("binomial gather requires power-of-2 p")
    rr = _rel(p, root)
    rel = x.new_zeros((x.shape[0], p) + x.shape[1:])
    rank_put_(rel, rr, x[:, None])
    half = 1
    while half < p:
        seg = rank_take(rel, rr, half)
        perm = [((root + j + half) % p, (root + j) % p)
                for j in range(0, p, 2 * half)]
        recv = transport.ppermute(seg, perm)
        tgt = [(q + half) % p for q in rr]
        mine = rank_take(rel, tgt, half)
        rank_put_(rel, tgt, rank_where([q % (2 * half) == 0 for q in rr],
                                       recv, mine))
        half *= 2
    return torch.roll(rel, root, 1)


@register_algorithm("gather", "xla")
def _gather_xla(x, p, root):
    """Vendor baseline (JAX: ``lax.all_gather``, root keeping the
    result): every block written to every rank by ``expand``."""
    del p, root
    full = gather_ranks(x)
    return full.unsqueeze(0).expand((x.shape[0],) + full.shape).contiguous()


GATHER_ALGORITHMS = ("linear", "binomial", "xla")


def gather_blocks(x: torch.Tensor, mesh, axis: str = DEFAULT_AXIS,
                  algorithm: str = "binomial", root: int = 0) -> torch.Tensor:
    """Gather all blocks to rank ``root``.

    ``x``: ``(p, ...)``. Returns ``(p, p, ...)`` stacked per-rank
    buffers; ``out[root]`` is the assembled gather (other rows are
    unspecified for the tree schedules).
    """
    return run_collective("gather", algorithm, mesh, axis, x, root)
