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
``check_sort`` is the inversion-count verifier (C18). ``sort`` probes
the chaos sites ``sort.<algorithm>`` (a delay, a death) at its dispatch
boundary, and ``checked=True`` runs the bitonic network's exchanges
through the checksum-carrying transport (``parallel.integrity``).
"""

from __future__ import annotations

from functools import partial

import torch

from icikit_torch import chaos
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

# the chaos sites: dispatch-boundary probes per algorithm, and the
# in-schedule corruption site of the checked bitonic exchange network
chaos.register_site(*(f"sort.{a}" for a in SORT_ALGORITHMS))
chaos.register_site("sort.bitonic.exchange")


def sort(x: torch.Tensor, mesh: RankMesh, axis: str = DEFAULT_AXIS,
         algorithm: str = "bitonic", checked: bool = False,
         retries: int = 2, **kw) -> torch.Tensor:
    """Sort flat ``x`` ascending across the mesh's ranks; returns the
    flat sorted tensor (same length and dtype) on the mesh's device.
    ``kw`` goes to the algorithm (``cap_factor`` for the sample sorts
    and quicksort).

    ``checked=True`` runs the checksum-carrying exchange network
    (bitonic only: the other sorts' ragged exchanges ride the vendor
    alltoall carrier in JAX, which stays unchecked): every
    compare-split block is verified at its receive step on the device,
    and a detected flip is quarantined and the deterministic schedule
    retried, at most ``retries`` times (``parallel.integrity``).
    """
    # the dispatch boundary's chaos sites: a straggling dispatch must
    # only ever be slow, never wrong
    chaos.maybe_delay(f"sort.{algorithm}")
    chaos.maybe_die(f"sort.{algorithm}")
    n = x.shape[0]
    if checked:
        if algorithm != "bitonic":
            raise ValueError(
                f"checked sort is the bitonic exchange network only "
                f"(got {algorithm!r}): the other sorts' ragged "
                "exchanges ride the opaque vendor alltoall")
        from icikit_torch.models.sort.bitonic import build_checked
        from icikit_torch.parallel import integrity
        blocks, _ = prepare_blocks(x, mesh, axis, pow2_local=True)
        prog, n_steps = build_checked(mesh, axis)
        out2d = integrity.checked_run(
            "sort.bitonic.exchange", prog, n_steps, mesh.shape[axis],
            (blocks,), retries=retries, label="sort/bitonic")
        return take_sorted(out2d, n)
    impl = get_algorithm("sort", algorithm)
    blocks, _ = prepare_blocks(x, mesh, axis,
                               pow2_local=(algorithm == "bitonic"))
    return take_sorted(impl(blocks, mesh, axis, **kw), n)
