"""The collective transport: every exchange of a rank-vectorised
schedule goes through :func:`ppermute`.

Ranks are the leading axis of one tensor (``utils.mesh.RankMesh``), so
a permutation is a gather along dim 0. This is the unchecked transport
only; the checksum-carrying mode of ``icikit.parallel.transport`` is
not ported yet.
"""

from __future__ import annotations

import torch


def ppermute(a: torch.Tensor, perm) -> torch.Tensor:
    """``lax.ppermute`` over the rank axis: for each ``(src, dst)`` in
    ``perm``, ``out[dst] = a[src]``; ranks that receive nothing get
    zeros, as in ``lax.ppermute``."""
    src = torch.tensor([s for s, _ in perm], dtype=torch.long,
                       device=a.device)
    dst = torch.tensor([d for _, d in perm], dtype=torch.long,
                       device=a.device)
    if len(perm) == a.shape[0]:
        out = torch.empty_like(a)
    else:
        out = torch.zeros_like(a)
    out[dst] = a[src]
    return out
