"""icikit_torch's sorting networks against the JAX package's Pallas kernels.

The same numpy inputs (made from a seed) go through
``icikit.ops.pallas_sort`` in Pallas interpret mode and through
``icikit_torch.ops.cuda_sort``, whose wrappers run the kernels' plain
PyTorch versions on CPU tensors. Tolerance: exact. Integer outputs are
compared bitwise; float outputs by value (``np.array_equal``), because
-0.0 and 0.0 compare equal and their order is arbitrary in both.
Small tile geometries (``t_grid=2^11``) drive every path: the
single-tile network, the gridded tile sort plus merge rounds, and the
multi-pass cross-tile rounds.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from icikit.ops import merge as jmerge
from icikit.ops import pallas_sort as ps
from icikit_torch.interop import from_jax, to_jax
from icikit_torch.ops import cuda_sort as cs
from icikit_torch.ops import merge as tmerge

SMALL = dict(t_grid=1 << 11, t_big=1 << 12)
MULTI_RANGE = dict(t_grid=1 << 11, t_big=1 << 11, g_max=1)


def _keys(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "int32":
        return rng.integers(-2**31, 2**31 - 1, size=n, dtype=np.int32)
    if kind == "float32":
        return rng.standard_normal(n).astype(np.float32)
    if kind == "uint32":
        return rng.integers(0, 2**32, size=n, dtype=np.uint32)
    if kind == "bfloat16":
        return np.asarray(jnp.asarray(rng.standard_normal(n).astype(
            np.float32)).astype(jnp.bfloat16))
    if kind == "dups":
        return rng.integers(-3, 4, size=n).astype(np.int32)
    raise ValueError(kind)


def _same(got: np.ndarray, want: np.ndarray) -> bool:
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    if got.dtype.kind == "f" or got.dtype.name == "bfloat16":
        return np.array_equal(got.astype(np.float32),
                              want.astype(np.float32))
    return np.array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("kind,n,geom", [
    ("int32", 1 << 13, {}),              # single tile
    ("int32", 1 << 14, SMALL),           # tile sort + merge + cross rounds
    ("int32", 1 << 14, MULTI_RANGE),     # cross rounds split by g_max
    ("float32", 10000, {}),              # non-power-of-2 padding
    ("float32", 1 << 14, MULTI_RANGE),
    ("uint32", 1 << 13, {}),
    ("uint32", 1 << 14, SMALL),
    ("bfloat16", 1 << 14, SMALL),        # widened to the f32 network
    ("dups", 12345, SMALL),
])
def test_local_sort_matches_pallas_interpret(kind, n, geom):
    x = _keys(kind, n, seed=n + len(geom))
    want = np.asarray(ps.local_sort(jnp.asarray(x), backend="interpret",
                                    **geom))
    got_t = cs.local_sort(from_jax(x), backend="kernel", **geom)
    assert got_t.dtype == from_jax(x).dtype
    got = to_jax(got_t)
    assert _same(got, want)
    assert _same(got, np.sort(x))


def _bitonic(n, seed, dtype=np.int32):
    rng = np.random.default_rng(seed)
    a = np.sort(rng.integers(0, 10**6, n // 2)).astype(dtype)
    b = np.sort(rng.integers(0, 10**6, n // 2)).astype(dtype)[::-1]
    return np.concatenate([a, b])


@pytest.mark.parametrize("n,geom,dtype", [
    (1 << 13, {}, np.int32),
    (1 << 14, SMALL, np.int32),
    (1 << 14, dict(t_grid=1 << 11, t_big=1 << 11, g_max=2), np.int32),
    (1 << 14, SMALL, np.float32),
    (1 << 13, {}, np.uint32),
])
def test_merge_bitonic_matches_pallas_interpret(n, geom, dtype):
    v = _bitonic(n, seed=n, dtype=dtype)
    want = np.asarray(ps.merge_bitonic(jnp.asarray(v), backend="interpret",
                                       **geom))
    got = to_jax(cs.merge_bitonic(from_jax(v), backend="kernel", **geom))
    assert _same(got, want)
    assert _same(got, np.sort(v))


def test_merge_bitonic_rows_are_independent_spans():
    """A (rows, n) input merges each row in the same passes, as the
    rank-vectorised bitonic sort uses it."""
    rows = np.stack([_bitonic(1 << 13, seed=s) for s in range(4)])
    got = to_jax(cs.merge_bitonic(from_jax(rows), backend="kernel",
                                  **SMALL))
    want = np.stack([np.asarray(ps.merge_bitonic(jnp.asarray(r),
                                                 backend="interpret",
                                                 **SMALL))
                     for r in rows])
    assert _same(got, want)


def test_geometry_does_not_change_the_network_output():
    x = _keys("float32", 1 << 14, seed=3)
    outs = [to_jax(cs.local_sort(from_jax(x), backend="kernel", **g))
            for g in ({}, SMALL, MULTI_RANGE,
                      dict(t_grid=1 << 12, t_big=1 << 12, g_max=1))]
    for o in outs[1:]:
        assert np.array_equal(o.view(np.uint32), outs[0].view(np.uint32))


def test_single_pass_wrappers_match_plain_versions_on_cpu():
    x = torch.from_numpy(_keys("int32", 1 << 13, seed=5))
    rounds = cs._sort_rounds(11)
    assert torch.equal(cs.net_pass(x, 1 << 11, rounds),
                       cs.net_pass_plain(x, 1 << 11, rounds))
    out = torch.empty_like(x)
    assert cs.cross_pass(x, 1 << 13, 1 << 11, 0, 1, False, out=out) is out
    assert torch.equal(out, cs.cross_pass_plain(x, 1 << 13, 1 << 11, 0, 1,
                                                False))
    assert cs.LAUNCHES == {"net": cs.LAUNCHES["net"],
                           "cross": cs.LAUNCHES["cross"]}


def test_schedule_pass_counts():
    """The phased schedule: one tile sort, then per merge round the
    cross passes (ceil(bits / g_max)) and one in-tile pass."""
    plan = cs.sort_schedule(1 << 28)
    assert plan[0] == ("net", cs.T_GRID, cs._sort_rounds(13))
    assert sum(s[0] == "net" for s in plan) == 1 + (28 - 13)
    assert sum(s[0] == "cross" for s in plan) == 9 * 1 + 6 * 2
    assert cs.sort_passes(1 << 28) == len(plan) == 37
    assert cs.sort_passes(100) == 0
    assert cs.merge_schedule(1 << 13) == [("net", 1 << 13,
                                           cs._merge_rounds(1 << 12))]


@pytest.mark.parametrize("kind", ["int32", "uint32", "float32"])
def test_min_kernel_fallback_matches_reference(kind):
    x = _keys(kind, 128, seed=9)
    assert cs._resolve_backend("auto", from_jax(x).dtype, 128) == "torch"
    assert ps._resolve_backend("auto", jnp.asarray(x).dtype, 128) == "xla"
    got = to_jax(cs.local_sort(from_jax(x)))
    assert _same(got, np.asarray(ps.local_sort(jnp.asarray(x))))


def test_auto_takes_the_network_at_min_kernel():
    assert cs._resolve_backend("auto", torch.int32, cs.MIN_KERNEL) == \
        "kernel"
    assert cs._resolve_backend("auto", torch.int16, cs.MIN_KERNEL) == \
        "torch"
    assert cs.MIN_KERNEL == ps.MIN_PALLAS


def test_unsupported_dtype_raises():
    with pytest.raises(ValueError, match="kernel sort supports"):
        cs.local_sort(torch.zeros(1 << 13, dtype=torch.int16),
                      backend="kernel")
    with pytest.raises(ValueError, match="unknown backend"):
        cs.local_sort(torch.zeros(1 << 13, dtype=torch.int32),
                      backend="pallas")


def test_merge_requires_pow2():
    with pytest.raises(ValueError, match="power-of-2"):
        cs.merge_bitonic(torch.zeros(3000, dtype=torch.int32),
                         backend="kernel")


def test_merge_validates_dtype_and_size():
    with pytest.raises(ValueError, match="kernel merge supports"):
        cs.merge_bitonic(torch.zeros(64, dtype=torch.int32),
                         backend="kernel")
    with pytest.raises(ValueError, match="kernel merge supports"):
        cs.merge_bitonic(torch.zeros(1 << 13, dtype=torch.int16),
                         backend="kernel")


def test_wrapper_geometry_errors():
    x = torch.zeros(1 << 13, dtype=torch.int32)
    with pytest.raises(ValueError, match="tile"):
        cs.net_pass(x, 3000, cs._sort_rounds(3))
    with pytest.raises(ValueError, match="bad geometry"):
        cs.cross_pass(x, 1 << 13, 1 << 11, 0, 2, False)
    with pytest.raises(ValueError, match="stride"):
        cs.net_pass(x, 1 << 4, cs._sort_rounds(5))


def test_merge_torch_backend_matches_reference():
    v = _bitonic(1 << 10, seed=1)
    got = to_jax(cs.merge_bitonic(from_jax(v), backend="torch"))
    want = np.asarray(ps.merge_bitonic(jnp.asarray(v), backend="xla"))
    assert _same(got, want)


def test_bitonic_merge_and_compare_split_match_reference():
    rng = np.random.default_rng(0)
    a = np.sort(rng.standard_normal(64).astype(np.float32))
    b = np.sort(rng.standard_normal(64).astype(np.float32))
    ta, tb = from_jax(a), from_jax(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    assert _same(to_jax(tmerge.compare_split_min(ta, tb)),
                 np.asarray(jmerge.compare_split_min(ja, jb)))
    assert _same(to_jax(tmerge.compare_split_max(ta, tb)),
                 np.asarray(jmerge.compare_split_max(ja, jb)))
    v = np.concatenate([a, b[::-1]])
    assert _same(to_jax(tmerge.bitonic_merge(from_jax(v))),
                 np.asarray(jmerge.bitonic_merge(jnp.asarray(v))))
    odd = rng.standard_normal(100).astype(np.float32)
    assert _same(to_jax(tmerge.bitonic_merge(from_jax(odd))), np.sort(odd))
