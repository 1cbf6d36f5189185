"""icikit_torch's variable-count exchanges against icikit.parallel.alltoallv.

The same seeded numpy segments and counts go through JAX's
``all_to_all_v``/``all_gather_v`` on the simulated CPU mesh and through
the port's on a CPU ``RankMesh``: rows (sentinel padding included),
counts and the overflow flag must agree bit for bit, on every carrier
schedule, at p = 8 and at p = 6.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from icikit.parallel import ALLTOALL_ALGORITHMS
from icikit.parallel import all_gather_v as j_all_gather_v
from icikit.parallel import all_to_all_v as j_all_to_all_v
from icikit.parallel.alltoallv import pack_segments as j_pack
from icikit.parallel.alltoallv import unpack_rows as j_unpack
from icikit.utils.mesh import make_mesh as j_make_mesh
from icikit.utils.mesh import shard_along as j_shard
from icikit_torch.parallel import all_gather_v, all_to_all_v
from icikit_torch.parallel.alltoallv import pack_segments, unpack_rows
from icikit_torch.utils.mesh import make_mesh


def _case(p, L, seed=0, max_seg=None):
    """Random per-pair counts with the contiguous MPI-style layout."""
    rng = np.random.default_rng(seed)
    max_seg = max_seg if max_seg is not None else L // p
    counts = rng.integers(0, max_seg + 1, size=(p, p)).astype(np.int32)
    data = np.full((p, L), -1, np.int32)
    for d in range(p):
        off = 0
        for j in range(p):
            c = counts[d, j]
            data[d, off:off + c] = rng.integers(0, 1000, c)
            off += c
    return data, counts


def _same(got, want):
    got = np.ascontiguousarray(got.numpy())
    want = np.ascontiguousarray(np.asarray(want))
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


def _alltoallv_both(p, data, counts, **kw):
    jm = j_make_mesh(p)
    want = j_all_to_all_v(j_shard(jnp.asarray(data), jm),
                          j_shard(jnp.asarray(counts), jm), jm, **kw)
    got = all_to_all_v(torch.from_numpy(data), torch.from_numpy(counts),
                       make_mesh(p, device="cpu"), **kw)
    for g, w in zip(got, want):
        _same(g, w)
    return got


@pytest.mark.parametrize("algorithm", ALLTOALL_ALGORITHMS)
def test_alltoallv_matches_jax(algorithm):
    data, counts = _case(8, 64, seed=1)
    rows, recv, overflow = _alltoallv_both(8, data, counts, capacity=8,
                                           algorithm=algorithm)
    assert int(overflow[0]) == 0
    assert np.array_equal(recv.numpy(), counts.T)


def test_alltoallv_overflow_flag():
    data, counts = _case(8, 64, seed=2, max_seg=8)
    counts[3, 5] = 8  # over the capacity 4 below
    rows, recv, overflow = _alltoallv_both(8, data, counts, capacity=4)
    assert int(overflow[0]) >= 1
    assert int(recv[5, 3]) == 4  # clamped, not lied about


def test_alltoallv_default_capacity():
    data, counts = _case(8, 32, seed=3)
    rows, _, overflow = _alltoallv_both(8, data, counts)
    assert tuple(rows.shape) == (8, 8, 32) and int(overflow[0]) == 0


@pytest.mark.parametrize("algorithm", ["wraparound", "naive", "xla"])
def test_alltoallv_non_pow2(algorithm):
    data, counts = _case(6, 36, seed=4)
    _alltoallv_both(6, data, counts, capacity=6, algorithm=algorithm)


@pytest.mark.parametrize("algorithm", ["xla", "ring", "recursive_doubling",
                                       "recursive_doubling_twins"])
def test_allgatherv_matches_jax(algorithm):
    p, cap = 8, 10
    rng = np.random.default_rng(10)
    counts = rng.integers(0, cap + 1, p).astype(np.int32)
    data = np.zeros((p, cap), np.int32)
    for d in range(p):
        data[d, :counts[d]] = rng.integers(0, 1000, counts[d])
    jm = j_make_mesh(p)
    want = j_all_gather_v(j_shard(jnp.asarray(data), jm),
                          j_shard(jnp.asarray(counts), jm), jm,
                          algorithm=algorithm)
    rows, all_counts = all_gather_v(torch.from_numpy(data),
                                    torch.from_numpy(counts),
                                    make_mesh(p, device="cpu"),
                                    algorithm=algorithm)
    _same(rows, want[0])
    _same(all_counts, want[1])
    flat, total = unpack_rows(rows[3], all_counts[3])
    jflat, jtotal = j_unpack(want[0][3], want[1][3])
    _same(flat, jflat)
    assert int(total) == int(jtotal) == counts.sum()


def test_pack_segments_matches_jax_per_rank_and_vectorised():
    data, counts = _case(4, 24, seed=5)
    starts = (np.cumsum(counts, 1) - counts).astype(np.int32)
    rows = pack_segments(torch.from_numpy(data), torch.from_numpy(starts),
                         torch.from_numpy(counts), 5)
    for d in range(4):
        want = j_pack(jnp.asarray(data[d]), jnp.asarray(starts[d]),
                      jnp.asarray(counts[d]), 5)
        _same(rows[d], want)
        _same(pack_segments(torch.from_numpy(data[d]),
                            torch.from_numpy(starts[d]),
                            torch.from_numpy(counts[d]), 5), want)


def test_allgatherv_validates():
    m = make_mesh(8, device="cpu")
    x = torch.zeros((8, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="counts must be"):
        all_gather_v(x, torch.zeros(4, dtype=torch.int32), m)
    with pytest.raises(ValueError, match="one .* block per device"):
        all_gather_v(torch.zeros((16, 4), dtype=torch.int32),
                     torch.zeros(8, dtype=torch.int32), m)
