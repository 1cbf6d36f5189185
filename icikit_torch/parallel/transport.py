"""The collective transport: every exchange of a rank-vectorised
schedule goes through :func:`ppermute`.

Ranks are the leading axis of one tensor (``utils.mesh.RankMesh``), so
a permutation is a gather along dim 0. The index tensors of a schedule
are static: :func:`index` builds each once per device and keeps it, so
an exchange issues no host-to-device copy after its first call (a copy
from pageable host memory would make the host wait for the stream to
drain). This is the unchecked transport only; the checksum-carrying
mode of ``icikit.parallel.transport`` is not ported yet (ROADMAP A5).
"""

from __future__ import annotations

from functools import lru_cache

import torch


@lru_cache(maxsize=None)
def index(values: tuple, device, dtype=torch.long) -> torch.Tensor:
    """The constant tensor ``values`` on ``device``, built once: the
    static index (or mask) tensors of a schedule."""
    return torch.tensor(values, dtype=dtype, device=device)


@lru_cache(maxsize=None)
def _plan(perm: tuple, p: int):
    """(inverse, None) for a full permutation, else (src, dst)."""
    if len(perm) == p:
        inv = [0] * p
        for s, d in perm:
            inv[d] = s
        return tuple(inv), None
    return tuple(s for s, _ in perm), tuple(d for _, d in perm)


def ppermute(a: torch.Tensor, perm) -> torch.Tensor:
    """``lax.ppermute`` over the rank axis: for each ``(src, dst)`` in
    ``perm``, ``out[dst] = a[src]``; ranks that receive nothing get
    zeros, as in ``lax.ppermute``. A full permutation is one gather."""
    src, dst = _plan(tuple(map(tuple, perm)), a.shape[0])
    if dst is None:
        return a.index_select(0, index(src, a.device))
    out = torch.zeros_like(a)
    if src:
        out.index_copy_(0, index(dst, a.device),
                        a.index_select(0, index(src, a.device)))
    return out
