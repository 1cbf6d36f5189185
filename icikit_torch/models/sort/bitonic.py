"""Distributed bitonic sort over the rank axis.

Reference: ``parallel_bitonic_sort`` (``Parallel-Sorting/src/psort.cc:
167-201``): local sort, then d(d+1)/2 compare-split rounds on a
d-dimensional hypercube: direction bit ``ibit = myid & 2^(i+1)``,
partner ``myid ^ 2^j``, keep-max iff ibit != jbit (``:184-195``). Here
the p ranks are the leading axis of one (p, n_loc) tensor, so each round
is one gather (``transport.ppermute``), one elementwise min/max and one
merge-network launch over all p rows at once.

Power-of-2 rank count required, as in the reference (``:168-172``).
"""

from __future__ import annotations

import torch

from icikit_torch.ops.cuda_sort import _i32_as_u32, _u32_as_i32, local_sort
from icikit_torch.ops.merge import bitonic_merge
from icikit_torch.parallel import transport
from icikit_torch.parallel.shmap import xor_perm
from icikit_torch.utils.mesh import (DEFAULT_AXIS, RankMesh,
                                     UnsupportedMeshError, ilog2, is_pow2)


def bitonic_sort_shard(a: torch.Tensor, p: int) -> torch.Tensor:
    """Rank-vectorised bitonic sort; ``a``: (p, n_loc), row r is rank
    r's unsorted block.

    Invariant: every row is sorted ascending after every compare-split,
    so the Batcher min/max-reverse identity applies at each round.
    Returns (p, n_loc) with row k the k-th block of the sorted sequence.
    """
    if not is_pow2(p):
        raise UnsupportedMeshError(
            f"bitonic sort requires a power-of-2 rank count (got {p}), "
            "as in the reference (psort.cc:168-172)")
    if a.shape[0] != p:
        raise ValueError(f"leading dim {a.shape[0]} != p={p}")
    usgn = a.dtype == torch.uint32
    if usgn:  # min/max and flips run on the order-preserving int32 image
        a = _u32_as_i32(a)
    rows = [local_sort(row) for row in a]
    a = rows[0][None] if p == 1 else torch.stack(rows)
    if p > 1:
        r = torch.arange(p, device=a.device)
        for i in range(ilog2(p)):
            for j in range(i, -1, -1):
                bit = 1 << j
                b = transport.ppermute(a, xor_perm(p, bit))
                ibit = (r & (1 << (i + 1))) != 0
                jbit = (r & bit) != 0
                keep_max = (ibit != jbit)[:, None]
                rb = b.flip(1)
                c = torch.where(keep_max, torch.maximum(a, rb),
                                torch.minimum(a, rb))
                a = bitonic_merge(c)
    return _i32_as_u32(a) if usgn else a


def bitonic_sort_blocks(x2d: torch.Tensor, mesh: RankMesh,
                        axis: str = DEFAULT_AXIS) -> torch.Tensor:
    """Sort (p, n_loc) data globally ascending; row k ends with block k
    of the sorted sequence. n_loc must be a power of 2 (use
    ``models.sort.sort`` for arbitrary flat inputs)."""
    return bitonic_sort_shard(x2d, mesh.shape[axis])
