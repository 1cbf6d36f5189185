"""Plumbing shared by every collective family: partner permutations,
the one call that runs a registered schedule, and the rank-vectorised
forms of ``shard_map``'s per-device indexing.

A schedule body sees all p ranks at once as dim 0 of one tensor, so a
rank-dependent slot (``lax.axis_index`` in JAX) is a static per-rank
list here, and each indexed read or write over all ranks is one gather
or one indexed copy with a cached index tensor (``transport.index``),
never a loop over ranks. With no jit or shard_map to wrap, a family's
entry point calls :func:`run_collective` directly.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from icikit_torch.parallel.transport import index
from icikit_torch.utils.registry import get_algorithm

COMBINE = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}


_ADAPTERS: dict = {}


def register_family(family: str, adapter) -> None:
    """A family whose program is more than its schedule (``scan``'s
    exclusive shift): ``adapter(impl, p, *extra)`` returns the body
    ``x -> out``. Other families run ``impl(x, p, *extra)``, as JAX's
    ``register_family`` adapters do."""
    _ADAPTERS[family] = adapter


def family_body(family: str, algorithm: str, p: int, *extra):
    """The program of ``family``'s registered ``algorithm`` at p ranks:
    a function of the ``(p, ...)`` operand, what JAX traces inside
    ``shard_map`` (checked runs trace it under a transport Tracker)."""
    impl = get_algorithm(family, algorithm)
    adapter = _ADAPTERS.get(family)
    if adapter is not None:
        return adapter(impl, p, *extra)
    return lambda x: impl(x, p, *extra)


def rank_operand(family: str, mesh, axis: str,
                 x: torch.Tensor) -> torch.Tensor:
    """``x`` on the mesh's device, after checking it is ``(p, ...)``."""
    p = mesh.shape[axis]
    if x.dim() < 1 or x.shape[0] != p:
        raise ValueError(f"{family} needs a (p={p}, ...) operand; got "
                         f"{tuple(x.shape)}")
    return x.to(mesh.device)


def run_collective(family: str, algorithm: str, mesh, axis: str,
                   x: torch.Tensor, *extra):
    """Run ``family``'s registered ``algorithm`` on ``x``, a ``(p, ...)``
    operand with p the size of ``mesh``'s ``axis``, on the mesh's
    device."""
    body = family_body(family, algorithm, mesh.shape[axis], *extra)
    return body(rank_operand(family, mesh, axis, x))


def reduce_ranks(x: torch.Tensor, op: str) -> torch.Tensor:
    """PyTorch's own reduction over the rank axis: the vendor baseline
    that XLA's psum/pmax/pmin are in JAX."""
    if op == "sum":
        return x.sum(0, dtype=x.dtype)
    return x.amax(0) if op == "max" else x.amin(0)


# -- partner permutations --------------------------------------------


@lru_cache(maxsize=None)
def xor_perm(p: int, mask: int):
    """Partner permutation ``j -> j ^ mask`` (a valid permutation for any
    mask in [1, p) when p is a power of two): the reference's hypercube
    partner rule ``myid ^ 2^i`` (``Communication/src/main.cc:84``) and
    e-cube rule ``myid ^ i`` (``:250``)."""
    return tuple((j, j ^ mask) for j in range(p))


@lru_cache(maxsize=None)
def shift_perm(p: int, shift: int):
    """Rotation permutation ``j -> (j + shift) % p``: the ring partner
    rule (``Communication/src/main.cc:198-221``, ``:379-385``)."""
    return tuple((j, (j + shift) % p) for j in range(p))


@lru_cache(maxsize=None)
def partial_shift_perm(p: int, step: int):
    """Right shift *without* wraparound: ``j -> j + step`` for
    ``j < p - step``, the targeted-``MPI_Send`` analog used where a
    wrapped value must not arrive (prefix scans: the top of the axis
    must never fold into the bottom's prefix)."""
    return tuple((j, j + step) for j in range(p - step))


# -- per-rank indexing, vectorised over the rank axis -----------------


@lru_cache(maxsize=None)
def _rows(n: int, starts: tuple, size: int) -> tuple:
    """Flat row indices of ``t[r, s_r : s_r + size]`` in a (p * n, ...)
    view, each start clamped into [0, n - size] as ``lax.dynamic_slice``
    and ``dynamic_update_slice`` clamp theirs."""
    out = []
    for r, s in enumerate(starts):
        s = min(max(s, 0), n - size)
        out.extend(r * n + s + k for k in range(size))
    return tuple(out)


def rank_take(t: torch.Tensor, starts, size: int) -> torch.Tensor:
    """Per rank r, ``t[r, s_r : s_r + size]`` (``dynamic_slice_in_dim``
    along the rank's dim 0): a new (p, size, ...) tensor."""
    p, n, tail = t.shape[0], t.shape[1], t.shape[2:]
    idx = index(_rows(n, tuple(starts), size), t.device)
    return t.reshape(p * n, *tail).index_select(0, idx).reshape(
        p, size, *tail)


def rank_put_(t: torch.Tensor, starts, upd: torch.Tensor) -> torch.Tensor:
    """In place, per rank r, ``t[r, s_r : s_r + size] = upd[r]``
    (``dynamic_update_slice_in_dim``); ``t`` must be contiguous."""
    p, n, tail = t.shape[0], t.shape[1], t.shape[2:]
    size = upd.shape[1]
    idx = index(_rows(n, tuple(starts), size), t.device)
    t.view(p * n, *tail).index_copy_(0, idx, upd.reshape(p * size, *tail))
    return t


def rank_where(mask, a: torch.Tensor, b) -> torch.Tensor:
    """Per rank r, ``a[r] if mask[r] else b[r]`` (``jnp.where`` on a
    predicate of ``lax.axis_index``); ``b`` may be a scalar."""
    m = index(tuple(bool(v) for v in mask), a.device, torch.bool)
    return torch.where(m.view(-1, *([1] * (a.dim() - 1))), a, b)


def rank_half(t: torch.Tensor, sel) -> torch.Tensor:
    """Per rank r, ``t[r, :, sel[r]]``: one half of a (p, g, 2, ...)
    split (``jnp.take(g, bit, axis=1)`` in the per-rank view)."""
    ranks = index(tuple(range(t.shape[0])), t.device)
    return t[ranks, :, index(tuple(sel), t.device)]
