"""Distributed sorting algorithms (the reference's Parallel-Sorting suite).

Ported so far: ``bitonic``, the hypercube compare-split network, through
the runtime registry as in ``icikit.models.sort``. ``sample``,
``sample_bitonic`` and ``quicksort`` (and ``checked=True``) raise
``NotImplementedError`` until their port (ROADMAP A6, A5).
``check_sort`` is the inversion-count verifier.
"""

from __future__ import annotations

import torch

from icikit_torch.models.sort.bitonic import bitonic_sort_blocks
from icikit_torch.models.sort.common import prepare_blocks, take_sorted
from icikit_torch.models.sort.verify import (  # noqa: F401
    check_sort,
    check_sort_shard,
)
from icikit_torch.utils.mesh import DEFAULT_AXIS, RankMesh
from icikit_torch.utils.registry import get_algorithm, register_algorithm

SORT_ALGORITHMS = ("bitonic", "sample", "sample_bitonic", "quicksort")
PORTED_ALGORITHMS = ("bitonic",)

register_algorithm("sort", "bitonic")(bitonic_sort_blocks)


def _not_ported(name: str):
    def impl(*_, **__):
        raise NotImplementedError(
            f"sort algorithm {name!r} is not ported to icikit_torch yet "
            "(ROADMAP A6); use algorithm='bitonic'")
    return impl


for _name in SORT_ALGORITHMS:
    if _name not in PORTED_ALGORITHMS:
        register_algorithm("sort", _name)(_not_ported(_name))


def sort(x: torch.Tensor, mesh: RankMesh, axis: str = DEFAULT_AXIS,
         algorithm: str = "bitonic", checked: bool = False
         ) -> torch.Tensor:
    """Sort flat ``x`` ascending across the mesh's ranks; returns the
    flat sorted tensor (same length and dtype) on the mesh's device."""
    if checked:
        raise NotImplementedError(
            "checked sort (checksum-carrying exchanges) is not ported to "
            "icikit_torch yet (ROADMAP A5)")
    impl = get_algorithm("sort", algorithm)
    n = x.shape[0]
    blocks, _ = prepare_blocks(x, mesh, axis,
                               pow2_local=(algorithm == "bitonic"))
    return take_sorted(impl(blocks, mesh, axis), n)
