"""Distributed sorting algorithms (the reference's Parallel-Sorting suite).

Four algorithms, selectable at runtime through the registry as in
``icikit.models.sort``:

- ``bitonic``        — C14: hypercube compare-split network.
- ``sample``         — C15: splitters from an allgathered sample set.
- ``sample_bitonic`` — C16: splitters sorted by the distributed bitonic
                       sort.
- ``quicksort``      — C17: recursive sub-cube partitioning by
                       median-of-medians pivots.

All take a flat tensor of any length, pad with dtype-max sentinels to
equal blocks, sort across the mesh's ranks, and return the flat sorted
tensor. ``sort_kv`` and ``argsort_dist`` carry values with the keys.
``check_sort`` is the inversion-count verifier (C18).
``checked=True`` (the checksum-carrying exchanges) raises until its
port (ROADMAP A5); so do the JAX package's fault-injection sites at the
dispatch boundary wait for its fault harness (ROADMAP A11).
"""

from __future__ import annotations

from functools import partial

import torch

from icikit_torch.models.sort.bitonic import bitonic_sort_blocks
from icikit_torch.models.sort.common import prepare_blocks, take_sorted
from icikit_torch.models.sort.kv import argsort_dist, sort_kv  # noqa: F401
from icikit_torch.models.sort.quicksort import hypercube_quicksort_blocks
from icikit_torch.models.sort.sample import sample_sort_blocks
from icikit_torch.models.sort.verify import (  # noqa: F401
    check_sort,
    check_sort_shard,
)
from icikit_torch.utils.mesh import DEFAULT_AXIS, RankMesh
from icikit_torch.utils.registry import get_algorithm, register_algorithm

# Block-level implementations (signature: (x2d, mesh, axis, **kw) ->
# sorted x2d).
register_algorithm("sort", "bitonic")(bitonic_sort_blocks)
register_algorithm("sort", "sample")(
    partial(sample_sort_blocks, splitter="allgather"))
register_algorithm("sort", "sample_bitonic")(
    partial(sample_sort_blocks, splitter="bitonic"))
register_algorithm("sort", "quicksort")(hypercube_quicksort_blocks)

SORT_ALGORITHMS = ("bitonic", "sample", "sample_bitonic", "quicksort")


def sort(x: torch.Tensor, mesh: RankMesh, axis: str = DEFAULT_AXIS,
         algorithm: str = "bitonic", checked: bool = False, **kw
         ) -> torch.Tensor:
    """Sort flat ``x`` ascending across the mesh's ranks; returns the
    flat sorted tensor (same length and dtype) on the mesh's device.
    ``kw`` goes to the algorithm (``cap_factor`` for the sample sorts
    and quicksort)."""
    if checked:
        raise NotImplementedError(
            "checked sort (checksum-carrying exchanges) is not ported to "
            "icikit_torch yet (ROADMAP A5)")
    impl = get_algorithm("sort", algorithm)
    n = x.shape[0]
    blocks, _ = prepare_blocks(x, mesh, axis,
                               pow2_local=(algorithm == "bitonic"))
    return take_sorted(impl(blocks, mesh, axis, **kw), n)
