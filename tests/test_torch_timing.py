"""icikit_torch's timing protocol and sort floor.

``_collect_windows`` is held against the JAX package's on the same
scripted (synthetic) timer readings; ``sort_floor_s`` is checked for the
two H100 parts and an unknown card, with no card attached.
"""

from __future__ import annotations

import pytest
import torch

from icikit.utils import timing as jtiming
from icikit_torch.bench.sort import hbm_nameplate_bytes, sort_floor_s
from icikit_torch.ops.cuda_sort import sort_passes
from icikit_torch.utils import timing as ttiming


def _scripted(readings):
    it = iter(readings)
    return lambda: (next(it), 1)


@pytest.mark.parametrize("seq,windows,floor,max_windows", [
    ([1.00, 1.02, 0.99, 5.0, 5.0, 5.0], 3, None, 9),      # stable
    ([1.0, 1.02, 1.5, 1.01, 0.99, 1.03, 1.0, 1.02, 0.98], 3, None, 9),
    ([1.0, 1.1, 1.05], 3, None, 9),                        # within bounds
    ([1.0, 2.0] * 20, 3, None, 9),                         # bimodal
    ([1.0, 1.01, 1.0, 1.02, 1.5] + [1.0, 1.01, 1.02, 1.0, 1.01], 5,
     None, 15),                                            # untrimmed trigger
    ([0.001, 1.0, 0.001, 1.02, 1.01, 5.0], 3, 0.5, 9),     # floor discards
])
def test_collect_windows_matches_reference(seq, windows, floor,
                                           max_windows):
    got = ttiming._collect_windows(_scripted(seq), windows, floor, 0.15,
                                   max_windows)
    want = jtiming._collect_windows(_scripted(seq), windows, floor, 0.15,
                                    max_windows)
    assert got == want


def test_median_and_convergence_match_reference():
    for xs in ([3.0], [1.0, 2.0], [5.0, 1.0, 3.0, 2.0]):
        assert ttiming._median(xs) == jtiming._median(xs)
    xs = [1.0, 1.01, 1.02, 1.0, 1.9]
    for trim in (False, True):
        assert (ttiming._spread_converged(xs, 0.15, trim)
                == jtiming._spread_converged(xs, 0.15, trim))


def test_timeit_windows_on_cpu_chain():
    res = ttiming.timeit_windows(lambda x: x + 1, (torch.ones(64),),
                                 lambda a, out: (out,), windows=3, runs=2)
    assert res.windows >= 3 and res.median_s > 0
    assert res.min_s <= res.median_s <= res.max_s
    q = res.session_quality()
    assert set(q) >= {"spread_ratio", "escalated", "degraded"}
    with pytest.raises(ValueError, match="windows"):
        ttiming.timeit_windows(lambda x: x, (torch.ones(1),),
                               lambda a, o: (o,), windows=0)


@pytest.mark.parametrize("name,bps", [
    ("NVIDIA H100 80GB HBM3", 3.35e12),
    ("NVIDIA H100 PCIe", 2.0e12),
    ("NVIDIA A100-SXM4-80GB", None),
    ("Some Future Card", None),
])
def test_sort_floor_by_card_name(name, bps):
    assert hbm_nameplate_bytes(name) == bps
    floor = sort_floor_s(1 << 28, 1, 4, device_name=name)
    if bps is None:
        assert floor is None
    else:
        # the port's geometry: 33 launches, each reading and writing 1 GiB
        assert sort_passes(1 << 28) == 33
        assert floor == pytest.approx(2 * 4 * (1 << 28) * 33 / bps)


def test_sort_floor_counts_every_rank_on_one_card():
    name = "NVIDIA H100 80GB HBM3"
    one = sort_floor_s(1 << 24, 1, 4, device_name=name)
    eight = sort_floor_s(1 << 24, 8, 4, device_name=name)
    assert eight == pytest.approx(one * sort_passes(1 << 21)
                                  / sort_passes(1 << 24))
