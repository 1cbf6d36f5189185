"""icikit_torch's distributed key-value sort and argsort against
icikit.models.sort.kv.

The cases of ``tests/test_sort_kv.py``: the same numpy keys and values
go through JAX's ``sort_kv``/``argsort_dist`` on the simulated CPU mesh
and through the port's on a CPU ``RankMesh``. Tolerance: exact (keys
bitwise or by value for floats, values bitwise), and both equal numpy's
stable argsort oracle. At the same keys and capacity the port's
overflow flags equal JAX's.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from icikit.models.sort import argsort_dist as j_argsort_dist
from icikit.models.sort import kv as JKV
from icikit.models.sort import sort_kv as j_sort_kv
from icikit.models.sort.common import prepare_blocks as j_prepare_blocks
from icikit.utils.mesh import make_mesh as j_make_mesh
from icikit_torch.interop import from_jax, to_jax
from icikit_torch.models.sort import argsort_dist, common, sort_kv
from icikit_torch.models.sort.common import prepare_blocks
from icikit_torch.models.sort.kv import sample_sort_kv_shard
from icikit_torch.utils.mesh import make_mesh


def _case(n, seed=0, dup_heavy=False, dtype=np.int32):
    rng = np.random.default_rng(seed)
    hi = 8 if dup_heavy else 10_000
    keys = rng.integers(-hi, hi, n).astype(dtype)
    vals = rng.integers(0, 1 << 30, n).astype(np.int32)
    return keys, vals


def _oracle(keys, vals):
    perm = np.argsort(keys, kind="stable")
    return keys[perm], vals[perm]


def _both(keys, vals, p, **kw):
    jk, jv = j_sort_kv(jnp.asarray(keys), jnp.asarray(vals),
                       j_make_mesh(p), **kw)
    tk, tv = sort_kv(from_jax(keys), from_jax(vals),
                     make_mesh(p, device="cpu"), **kw)
    return (to_jax(tk), to_jax(tv)), (np.asarray(jk), np.asarray(jv))


def _check(keys, vals, p, **kw):
    (tk, tv), (jk, jv) = _both(keys, vals, p, **kw)
    ek, ev = _oracle(keys, vals)
    for got, want in ((tk, jk), (tk, ek)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tv, ev)


@pytest.mark.parametrize("splitter", ["allgather", "bitonic"])
@pytest.mark.parametrize("n", [256, 1000])  # 1000: padding path
def test_sort_kv_matches_reference(splitter, n):
    keys, vals = _case(n, seed=1)
    _check(keys, vals, 8, splitter=splitter)


@pytest.mark.parametrize("p", [2, 4, 8])
def test_sort_kv_duplicate_keys_stable(p):
    """Heavy duplicates: stability decides the value order."""
    keys, vals = _case(512, seed=2, dup_heavy=True)
    _check(keys, vals, p)


def test_sort_kv_max_keys_keep_values():
    """Keys at the dtype max (the sentinel value) stay paired: the
    validity-flag design, not the sentinel trick."""
    keys = np.full(64, np.iinfo(np.int32).max, np.int32)
    keys[::3] = 7
    _check(keys, np.arange(64, dtype=np.int32), 8)


def test_sort_kv_float_keys():
    rng = np.random.default_rng(3)
    keys = rng.standard_normal(300).astype(np.float32)
    _check(keys, np.arange(300, dtype=np.int32), 8)


def test_sort_kv_uint32_keys():
    rng = np.random.default_rng(8)
    keys = rng.integers(0, 2**32, 700, dtype=np.uint32)
    keys[::5] = 2**32 - 1
    _check(keys, np.arange(700, dtype=np.int32), 4)


@pytest.mark.parametrize("splitter", ["allgather", "bitonic"])
def test_sort_kv_skewed_overflow_retry(splitter):
    """All keys equal: every element routes to one bucket, far past the
    first capacity; the retry at the safe capacity keeps it exact."""
    keys = np.zeros(512, np.int32)
    common.reset_retries()
    _check(keys, np.arange(512, dtype=np.int32), 8, splitter=splitter)
    assert common.RETRIES["sample"] == 1


@pytest.mark.parametrize("p", [4, 8])
@pytest.mark.parametrize("splitter", ["allgather", "bitonic"])
@pytest.mark.parametrize("factor", [1.25, 2.0, 4.0])
def test_sort_kv_overflow_decisions_match_reference(p, splitter, factor):
    keys, vals = _case(4096, seed=p, dup_heavy=True)
    jmesh = j_make_mesh(p)
    jk, n_loc = j_prepare_blocks(jnp.asarray(keys), jmesh)
    jv, _ = j_prepare_blocks(jnp.asarray(vals), jmesh, fill=0)
    mesh = make_mesh(p, device="cpu")
    tk, _ = prepare_blocks(from_jax(keys), mesh)
    tv, _ = prepare_blocks(from_jax(vals), mesh, fill=0)
    cap = max(1, min(n_loc, int(factor * n_loc / p)))
    jko, jvo, jovf = JKV._build(jmesh, "p", cap, splitter)(jk, jv)
    tko, tvo, tovf = sample_sort_kv_shard(tk, tv, p, cap, splitter)
    assert np.array_equal(to_jax(tovf), np.asarray(jovf))
    if not int(np.asarray(jovf).sum()):
        np.testing.assert_array_equal(to_jax(tko), np.asarray(jko))
        np.testing.assert_array_equal(to_jax(tvo), np.asarray(jvo))


@pytest.mark.parametrize("p", [1, 8])
def test_argsort_dist(p):
    keys, _ = _case(400, seed=4, dup_heavy=True)
    want = np.asarray(j_argsort_dist(jnp.asarray(keys), j_make_mesh(p)))
    got = argsort_dist(from_jax(keys), make_mesh(p, device="cpu"))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(to_jax(got), want)
    np.testing.assert_array_equal(to_jax(got),
                                  np.argsort(keys, kind="stable"))


def test_sort_kv_shape_mismatch():
    with pytest.raises(ValueError, match="identical shapes"):
        sort_kv(torch.zeros(8), torch.zeros(9), make_mesh(8, device="cpu"))


def test_sort_kv_p1():
    keys, vals = _case(128, seed=5)
    _check(keys, vals, 1)


def test_sort_kv_non_pow2_mesh():
    keys, vals = _case(300, seed=6)
    _check(keys, vals, 6)


def test_sort_kv_at_the_network_size():
    """n/p = 2^13 keys a rank with heavy duplicates, beside the key-only
    sorts' network size; the values follow the keys."""
    keys, vals = _case(1 << 16, seed=7, dup_heavy=True)
    _check(keys, vals, 8, splitter="bitonic")
