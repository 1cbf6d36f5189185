"""icikit_torch.utils.prandom: the odd_dist skew against JAX's, and the
port's own generators' partition invariance.

``odd_dist_warp`` applies JAX's formula in the same dtype and order of
operations; the two agree bit for bit on most elements and differ only
where the float32 ``pow`` rounds differently: XLA's and torch's are
each within 1 ulp of the exact power (checked below against float64),
and the square doubles that relative difference, so the tolerance is 4
ulp. XLA on the CPU also flushes subnormal results to zero, so results
below float32's smallest normal are compared as <= that bound. The
generators' bits are not JAX's (torch has no cheap threefry): they are
held to their own invariants.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from icikit.utils.prandom import odd_dist_warp as j_odd_dist_warp
from icikit_torch.interop import from_jax
from icikit_torch.models.sort.common import prepare_blocks
from icikit_torch.utils.mesh import make_mesh
from icikit_torch.utils.prandom import (odd_dist_warp, uniform_block,
                                        uniform_global)

TINY = np.finfo(np.float32).tiny
ULP_TOL = 4


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def _close_to_reference(got, want):
    normal = want >= TINY
    assert np.all(got[~normal] <= TINY)
    d = _ulps(got[normal], want[normal])
    assert d.max() <= ULP_TOL
    assert (d == 0).mean() > 0.95


@pytest.mark.parametrize("n", [1000, 1 << 20])
def test_odd_dist_warp_matches_reference(n):
    u = np.random.default_rng(n).random(n).astype(np.float32)
    want = np.asarray(j_odd_dist_warp(jnp.asarray(u)))
    got = odd_dist_warp(from_jax(u)).numpy()
    _close_to_reference(got, want)


def test_odd_dist_warp_block_matches_reference():
    u = np.random.default_rng(1).random(4096).astype(np.float32)
    want = np.asarray(j_odd_dist_warp(jnp.asarray(u[1000:3000]),
                                      global_offset=1000, global_n=4096))
    got = odd_dist_warp(from_jax(u[1000:3000]), global_offset=1000,
                        global_n=4096).numpy()
    _close_to_reference(got, want)
    whole = odd_dist_warp(from_jax(u)).numpy()
    assert np.array_equal(got, whole[1000:3000])


def test_pow_each_within_one_ulp_of_exact():
    """The premise of the tolerance: both float32 powers are within 1
    ulp of the float64 power rounded to float32."""
    n = 1 << 16
    u = np.random.default_rng(2).random(n).astype(np.float32)
    e = (np.float32(1.0) + np.float32(3.0) * np.arange(n, dtype=np.float32)
         / np.float32(n)).astype(np.float32)
    exact = (u.astype(np.float64) ** e.astype(np.float64)).astype(np.float32)
    jp = np.asarray(jnp.power(jnp.asarray(u), jnp.asarray(e)))
    tp = torch.pow(torch.from_numpy(u), torch.from_numpy(e)).numpy()
    normal = exact >= TINY
    assert _ulps(jp[normal], exact[normal]).max() <= 1
    assert _ulps(tp[normal], exact[normal]).max() <= 1


@pytest.mark.parametrize("odd_dist", [False, True])
def test_uniform_global_is_partition_invariant(odd_dist):
    """One generator makes the whole sequence: every p's blocks
    concatenate to the same keys, and a second call repeats it."""
    n = 10_000
    whole = uniform_global(3, n, odd_dist=odd_dist, device="cpu")
    assert torch.equal(whole, uniform_global(3, n, odd_dist=odd_dist,
                                             device="cpu"))
    for p in (1, 2, 4, 8):
        blocks, n_loc = prepare_blocks(whole, make_mesh(p, device="cpu"))
        assert torch.equal(blocks.reshape(-1)[:n], whole)
    assert not torch.equal(whole, uniform_global(4, n, odd_dist=odd_dist,
                                                 device="cpu"))


@pytest.mark.parametrize("odd_dist", [False, True])
@pytest.mark.parametrize("start,block", [(0, 1), (5, 1000), (4096, 4096),
                                         (12345, 7655)])
def test_uniform_block_equals_the_slice_of_the_whole(odd_dist, start,
                                                     block):
    n = 20_000
    whole = uniform_block(9, n, 0, n, odd_dist=odd_dist, device="cpu")
    part = uniform_block(9, n, start, block, odd_dist=odd_dist,
                         device="cpu")
    assert torch.equal(part, whole[start:start + block])


def test_uniform_block_partitions_concatenate():
    n, p = 1 << 14, 8
    whole = uniform_block(1, n, 0, n, device="cpu")
    parts = [uniform_block(1, n, r * n // p, n // p, device="cpu")
             for r in range(p)]
    assert torch.equal(torch.cat(parts), whole)


@pytest.mark.parametrize("gen", ["global", "block"])
def test_distribution_is_uniform(gen):
    """A loose check: mean, standard deviation, every decile within
    tolerance of 1/10, and the range inside [0, 1)."""
    n = 1 << 18
    x = (uniform_global(0, n, device="cpu") if gen == "global"
         else uniform_block(0, n, 0, n, device="cpu")).double()
    assert 0.0 <= float(x.min()) and float(x.max()) < 1.0
    assert abs(float(x.mean()) - 0.5) < 0.005
    assert abs(float(x.std()) - (1 / 12) ** 0.5) < 0.005
    hist = torch.histc(x, bins=10, min=0.0, max=1.0) / n
    assert torch.all((hist - 0.1).abs() < 0.005)


def test_odd_dist_skews_toward_zero():
    """The skew grows with the index: the last decile of positions draws
    far smaller values than the first."""
    n = 1 << 16
    x = uniform_global(0, n, odd_dist=True, device="cpu")
    assert float(x[: n // 10].mean()) > 2 * float(x[-n // 10:].mean())


def test_dtype_and_device():
    x = uniform_global(0, 100, dtype=torch.bfloat16, device="cpu")
    assert x.dtype == torch.bfloat16 and x.device.type == "cpu"
    y = uniform_block(0, 100, 0, 100, dtype=torch.bfloat16, device="cpu")
    assert y.dtype == torch.bfloat16
