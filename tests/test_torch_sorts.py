"""icikit_torch's sample, sample_bitonic and quicksort against
icikit.models.sort.

The same numpy keys go through ``icikit.models.sort.sort(x,
make_mesh(p), algorithm=a)`` on the simulated CPU mesh and through the
port's rank-vectorised ``sort`` on a CPU ``RankMesh``, p in {1, 2, 4,
8}. Tolerance: exact (integers bitwise, floats by value). At the same
keys and capacity the port's overflow flags equal JAX's, its retries
fire where JAX's do, and it raises where JAX raises. Sizes with n/p >=
2^13 drive the network's plain versions (``ops.cuda_sort``) in the
first sort, the post-exchange sort and quicksort's rounds.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from icikit.models.sort import quicksort as JQ
from icikit.models.sort import sample as JS
from icikit.models.sort import sort as j_sort
from icikit.models.sort.common import prepare_blocks as j_prepare_blocks
from icikit.utils.mesh import UnsupportedMeshError as JUnsupported
from icikit.utils.mesh import make_mesh as j_make_mesh
from icikit.utils.prandom import odd_dist_warp as j_odd_dist_warp
from icikit_torch.interop import from_jax, to_jax
from icikit_torch.models.sort import SORT_ALGORITHMS, sort
from icikit_torch.models.sort import common
from icikit_torch.models.sort.common import prepare_blocks
from icikit_torch.models.sort.quicksort import (hypercube_quicksort_blocks,
                                                hypercube_quicksort_shard)
from icikit_torch.models.sort.sample import sample_sort_shard
from icikit_torch.ops import cuda_sort as cs
from icikit_torch.utils.mesh import UnsupportedMeshError, make_mesh
from icikit_torch.utils.registry import list_algorithms

ALGS = ("sample", "sample_bitonic", "quicksort")


def _keys(kind, n, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "int32":
        return rng.integers(-2**31, 2**31 - 1, size=n).astype(np.int32)
    if kind == "uniform_f32":
        return rng.random(n).astype(np.float32)
    if kind == "odd_dist":
        u = rng.random(n).astype(np.float32)
        return np.asarray(j_odd_dist_warp(jnp.asarray(u)))
    if kind == "odd_int32":
        u = np.asarray(j_odd_dist_warp(jnp.asarray(
            rng.random(n).astype(np.float32))))
        return (u * 2e9 - 1e9).astype(np.int32)
    if kind == "dups":
        return rng.integers(0, 7, size=n).astype(np.int32)
    if kind == "uint32":
        return rng.integers(0, 2**32, size=n, dtype=np.uint32)
    if kind == "bfloat16":
        return np.asarray(jnp.asarray(rng.standard_normal(n).astype(
            np.float32)).astype(jnp.bfloat16))
    if kind == "int32_max":   # keys equal to the sentinel
        x = rng.integers(-50, 50, size=n).astype(np.int32)
        x[::3] = np.iinfo(np.int32).max
        return x
    raise ValueError(kind)


def _both(x, p, algorithm, **kw):
    want = np.asarray(j_sort(jnp.asarray(x), j_make_mesh(p),
                             algorithm=algorithm, **kw))
    got = to_jax(sort(from_jax(x), make_mesh(p, device="cpu"),
                      algorithm=algorithm, **kw))
    return got, want


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype.kind == "f" or got.dtype.name == "bfloat16":
        np.testing.assert_array_equal(got.astype(np.float32),
                                      want.astype(np.float32))
    else:
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("p", [1, 2, 4, 8])
@pytest.mark.parametrize("algorithm", ALGS)
@pytest.mark.parametrize("kind", ["int32", "uniform_f32", "odd_dist",
                                  "dups"])
def test_sort_matches_reference(p, algorithm, kind):
    x = _keys(kind, 1 << 12, seed=p)
    got, want = _both(x, p, algorithm)
    _same(got, want)
    _same(got, np.sort(x))


@pytest.mark.parametrize("p", [1, 2, 4, 8])
@pytest.mark.parametrize("algorithm", ALGS)
def test_sort_ragged_length(p, algorithm):
    """1000 keys: n not a multiple of p at 8 (n_loc 125), the sentinel
    padding, and rows that are not a power of two."""
    x = _keys("int32", 1000, seed=3 + p)
    got, want = _both(x, p, algorithm)
    _same(got, want)


@pytest.mark.parametrize("p", [1, 8])
@pytest.mark.parametrize("algorithm", ALGS)
def test_sort_empty_input(p, algorithm):
    x = np.zeros((0,), np.int32)
    got, want = _both(x, p, algorithm)
    assert got.shape == want.shape == (0,)


@pytest.mark.parametrize("algorithm", ALGS)
@pytest.mark.parametrize("kind", ["uint32", "bfloat16", "int32_max"])
def test_sort_other_dtypes(algorithm, kind):
    """uint32 rides the int32 image, bf16 the float32 network; keys
    equal to the dtype's maximum (the sentinel) sort like any other."""
    x = _keys(kind, 3000, seed=17)
    got, want = _both(x, 4, algorithm)
    _same(got, want)


@pytest.mark.parametrize("p,n,algorithm,kind", [
    (2, 1 << 14, "sample", "int32"),
    (2, 1 << 14, "sample_bitonic", "uniform_f32"),
    (2, 1 << 14, "quicksort", "odd_dist"),
    (8, 1 << 16, "sample", "odd_int32"),
    (8, 1 << 16, "quicksort", "int32"),
    (4, (1 << 15) + 3, "sample_bitonic", "dups"),
])
def test_sort_through_the_network(p, n, algorithm, kind):
    """n/p >= 2^13: every local sort of at least MIN_KERNEL keys takes
    the network, here its plain versions; no kernel launches on the
    CPU."""
    x = _keys(kind, n, seed=11)
    cs.reset_launches()
    got, want = _both(x, p, algorithm)
    _same(got, want)
    _same(got, np.sort(x))
    assert cs.LAUNCHES == {"net": 0, "cross": 0}


def _blocks(x, p):
    jmesh = j_make_mesh(p)
    jx, n_loc = j_prepare_blocks(jnp.asarray(x), jmesh)
    tx, _ = prepare_blocks(from_jax(x), make_mesh(p, device="cpu"))
    return jmesh, jx, tx, n_loc


@pytest.mark.parametrize("p", [4, 8])
@pytest.mark.parametrize("splitter", ["allgather", "bitonic"])
@pytest.mark.parametrize("factor", [0.5, 1.25, 2.0, 3.0, 4.0])
def test_sample_overflow_decisions_match_reference(p, splitter, factor):
    x = _keys("odd_int32", 1 << 13, seed=p)
    jmesh, jx, tx, n_loc = _blocks(x, p)
    cap = max(1, min(n_loc, int(factor * n_loc / p)))
    jout, jovf = JS._build(jmesh, "p", cap, splitter)(jx)
    tout, tovf = sample_sort_shard(tx, p, cap, splitter)
    assert np.array_equal(to_jax(tovf), np.asarray(jovf))
    if not int(np.asarray(jovf).sum()):
        _same(to_jax(tout), np.asarray(jout))


@pytest.mark.parametrize("p", [4, 8])
@pytest.mark.parametrize("factor", [1.0, 1.25, 2.0])
@pytest.mark.parametrize("kind", ["odd_int32", "dups"])
def test_quicksort_overflow_decisions_match_reference(p, factor, kind):
    x = _keys(kind, 1 << 13, seed=p)
    jmesh, jx, tx, n_loc = _blocks(x, p)
    cap = int(factor * n_loc)
    jout, jovf = JQ._build(jmesh, "p", cap)(jx)
    tout, tovf = hypercube_quicksort_shard(tx, p, cap)
    assert np.array_equal(to_jax(tovf), np.asarray(jovf))
    if not int(np.asarray(jovf).sum()):
        _same(to_jax(tout), np.asarray(jout))


@pytest.mark.parametrize("algorithm,data,retries", [
    # all-equal data lands in one bucket, the worst skew
    ("sample", "skewed", {"sample": 1, "quicksort": 0}),
    ("sample_bitonic", "skewed", {"sample": 1, "quicksort": 0}),
    # every round's pivot equals every element: capacity doubles twice
    ("quicksort", "equal", {"sample": 0, "quicksort": 2}),
])
def test_retry_paths_match_reference(algorithm, data, retries):
    x = np.full(1 << 10, 42, np.int32)
    if data == "skewed":
        x[::7] = 41
    common.reset_retries()
    got, want = _both(x, 8, algorithm)
    _same(got, want)
    _same(got, np.sort(x))
    assert common.RETRIES == retries


def test_forced_retries_at_small_capacity_factors():
    """chip_smoke's forced retries at a CPU size: sample at cap_factor
    0.5 and quicksort at 1.0 on odd_dist keys take their retry paths
    and still equal JAX's sorts at the same factors."""
    x = _keys("odd_int32", 1 << 14, seed=5)
    for algorithm, factor, kind in (("sample", 0.5, "sample"),
                                    ("quicksort", 1.0, "quicksort")):
        common.reset_retries()
        got, want = _both(x, 8, algorithm, cap_factor=factor)
        _same(got, want)
        assert common.RETRIES[kind] >= 1


def test_quicksort_irreducible_skew_raises():
    x = np.full(1 << 10, 7, np.int32)
    jmesh, jx, tx, _ = _blocks(x, 8)
    with pytest.raises(RuntimeError, match="skew"):
        JQ.hypercube_quicksort_blocks(jx, jmesh, cap_factor=1.0,
                                      max_cap_factor=1.0)
    with pytest.raises(RuntimeError, match="skew"):
        hypercube_quicksort_blocks(tx, make_mesh(8, device="cpu"),
                                   cap_factor=1.0, max_cap_factor=1.0)


@pytest.mark.parametrize("algorithm", ["quicksort", "sample_bitonic",
                                       "bitonic"])
def test_non_pow2_ranks_raise_where_reference_raises(algorithm):
    x = np.arange(96, dtype=np.int32)
    with pytest.raises(JUnsupported):
        j_sort(jnp.asarray(x), j_make_mesh(6), algorithm=algorithm)
    with pytest.raises(UnsupportedMeshError, match="power-of-2"):
        sort(from_jax(x), make_mesh(6, device="cpu"), algorithm=algorithm)


def test_sample_at_six_ranks_matches_reference():
    x = _keys("odd_dist", 3000, seed=6)
    got, want = _both(x, 6, "sample")
    _same(got, want)


def test_registry_lists_all_four():
    assert set(list_algorithms("sort")) == set(SORT_ALGORITHMS)
    assert len(SORT_ALGORITHMS) == 4


def test_cap_factor_reaches_the_algorithm():
    """``sort``'s keywords go to the algorithm: a cap_factor that
    overflows takes the retry."""
    x = from_jax(_keys("int32", 1 << 10, seed=2))
    common.reset_retries()
    out = sort(x, make_mesh(8, device="cpu"), algorithm="sample",
               cap_factor=0.25)
    assert torch.equal(out, torch.sort(x).values)
    assert common.RETRIES["sample"] == 1


def test_rows_local_sort_equals_the_per_row_loop():
    """``local_sort`` of (rows, n) against a loop over its rows, at
    small tile geometries that drive the in-tile sort, the round passes
    and the cross passes, with the top round ascending in every row."""
    rng = np.random.default_rng(9)
    for n, dtype in ((1 << 13, np.int32), (1 << 15, np.int32),
                     (20000, np.float32)):
        x = torch.from_numpy(rng.integers(-1000, 1000, (4, n)).astype(dtype))
        for geom in ({}, dict(t_grid=1 << 11, t_big=1 << 12),
                     dict(t_grid=1 << 11, t_big=1 << 11, g_max=1)):
            got = cs.local_sort(x, backend="kernel", **geom)
            want = torch.stack([cs.local_sort(r, backend="kernel", **geom)
                                for r in x])
            assert torch.equal(got, want)
            assert torch.equal(got, torch.sort(x, dim=1).values)
