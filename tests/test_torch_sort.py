"""icikit_torch's distributed bitonic sort against icikit.models.sort.

The same numpy keys go through ``icikit.models.sort.sort(x,
make_mesh(p), algorithm="bitonic")`` on the simulated CPU mesh and
through the port's rank-vectorised ``sort`` on a CPU ``RankMesh``, for
p in {1, 2, 4, 8}. Tolerance: exact (integers bitwise, floats by value).
Sizes with n/p >= 2^13 drive the port's network (the plain versions of
its kernels on the CPU), with more than one rank through the
merge-network rounds of the compare-split.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from icikit.models.sort import check_sort as j_check_sort
from icikit.models.sort import sort as j_sort
from icikit.models.sort.common import prepare_blocks as j_prepare_blocks
from icikit.utils.mesh import make_mesh as j_make_mesh
from icikit_torch.interop import from_jax, to_jax
from icikit_torch.models.sort import check_sort, sort
from icikit_torch.models.sort.common import prepare_blocks
from icikit_torch.ops import cuda_sort as cs
from icikit_torch.utils.mesh import UnsupportedMeshError, make_mesh


def _keys(kind, n, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "int32":
        return rng.integers(-2**31, 2**31 - 1, size=n).astype(np.int32)
    if kind == "uniform_f32":
        return rng.random(n).astype(np.float32)
    if kind == "dups":
        return rng.integers(0, 7, size=n).astype(np.int32)
    if kind == "uint32":
        return rng.integers(0, 2**32, size=n, dtype=np.uint32)
    raise ValueError(kind)


def _both(x, p):
    want = np.asarray(j_sort(jnp.asarray(x), j_make_mesh(p),
                             algorithm="bitonic"))
    got = to_jax(sort(from_jax(x), make_mesh(p, device="cpu"),
                      algorithm="bitonic"))
    return got, want


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype.kind == "f":
        np.testing.assert_array_equal(got, want)
    else:
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("p", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", ["int32", "uniform_f32", "dups"])
def test_sort_matches_reference(p, kind):
    x = _keys(kind, 1 << 12, seed=p)
    got, want = _both(x, p)
    _same(got, want)
    _same(got, np.sort(x))


@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_sort_ragged_length(p):
    """Lengths not divisible by p take the sentinel-padding path
    (1000 at p = 8 pads n_loc 125 -> 128)."""
    x = _keys("int32", 1000, seed=3 + p)
    got, want = _both(x, p)
    _same(got, want)


@pytest.mark.parametrize("p,n,kind", [
    (1, 1 << 14, "int32"),        # one rank: the whole network
    (2, 1 << 14, "int32"),        # n_loc 2^13: network + 2^13 merges
    (2, (1 << 14) - 5, "dups"),   # ragged, duplicates, sentinel pad
    (1, 20000, "uniform_f32"),
    (2, 1 << 14, "uint32"),
])
def test_sort_through_the_network(p, n, kind):
    x = _keys(kind, n, seed=11)
    cs.reset_launches()
    got, want = _both(x, p)
    _same(got, want)
    _same(got, np.sort(x))
    # CPU tensors run the plain versions: no kernel was launched
    assert cs.LAUNCHES == {"net": 0, "cross": 0}


@pytest.mark.parametrize("p", [4, 8])
def test_check_sort_counts_match_reference(p):
    rng = np.random.default_rng(p)
    x = np.sort(_keys("int32", 1 << 10, seed=p))
    for i in rng.choice(len(x) - 1, size=5, replace=False):
        x[i], x[i + 1] = x[i + 1], x[i]
    x[len(x) // p - 1] = 2**31 - 1   # a boundary inversion
    jblocks, _ = j_prepare_blocks(jnp.asarray(x), j_make_mesh(p))
    want = j_check_sort(jblocks, j_make_mesh(p))
    mesh = make_mesh(p, device="cpu")
    blocks, _ = prepare_blocks(from_jax(x), mesh)
    assert check_sort(blocks, mesh) == want > 0
    assert check_sort(torch.sort(blocks.reshape(-1)).values.reshape(p, -1),
                      mesh) == 0


def test_non_pow2_ranks_raise():
    with pytest.raises(UnsupportedMeshError, match="power-of-2"):
        sort(torch.arange(96, dtype=torch.int32),
             make_mesh(3, device="cpu"))


def test_checked_sort_raises():
    """``sort(checked=True)`` (ported since this test's name was given)
    equals ``sort()``; it raises, as JAX's does, only for an algorithm
    other than the bitonic network."""
    x = from_jax(_keys("int32", 1 << 14, seed=6))
    mesh = make_mesh(2, device="cpu")
    assert torch.equal(sort(x, mesh, checked=True), sort(x, mesh))
    with pytest.raises(ValueError, match="bitonic"):
        sort(x, mesh, algorithm="quicksort", checked=True)


def test_unknown_algorithm_lists_known():
    with pytest.raises(KeyError, match="bitonic"):
        sort(torch.arange(64, dtype=torch.int32),
             make_mesh(2, device="cpu"), algorithm="bogo")


def test_ppermute_is_a_rank_gather():
    from icikit_torch.parallel.shmap import shift_perm, xor_perm
    from icikit_torch.parallel.transport import ppermute
    a = torch.arange(8).reshape(4, 2)
    assert torch.equal(ppermute(a, xor_perm(4, 1))[:, 0],
                       torch.tensor([2, 0, 6, 4]))
    assert torch.equal(ppermute(a, shift_perm(4, 1))[:, 0],
                       torch.tensor([6, 0, 2, 4]))
    partial = ppermute(a, [(0, 1)])
    assert torch.equal(partial, torch.tensor([[0, 0], [0, 1], [0, 0],
                                              [0, 0]]))
