"""icikit_torch's collective library against icikit.parallel.

The same numpy inputs, made from a seed, go through each JAX family on
the simulated CPU mesh (``make_mesh(p)``) and through the port's
rank-vectorised twin on a CPU ``RankMesh(p)``, for every registered
variant at p in {1, 2, 3, 4, 5, 6, 8}. Where JAX raises
``UnsupportedMeshError``, so must the port.

Tolerance: bitwise for every hand-rolled schedule (floats included: the
port combines in the schedule's own order) and for every integer or
data-movement result; rtol 1e-6 only for the ``"xla"`` float sums,
whose order is XLA's on one side and PyTorch's on the other. Their
inputs are positive (no cancellation), so a reordered float32 sum of
at most 8 terms moves by at most 8 ulps, under 1e-6 relative.

Each (variant, p) is one case with one dtype/op combination, cycling
through int32 and float32 with sum, max and min across the p's the
variant accepts, so every JAX program compiles once and each variant
meets every combination.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from icikit import parallel as jp
from icikit.models.sort import sort as j_sort
from icikit.utils.mesh import UnsupportedMeshError as JUnsupported
from icikit.utils.mesh import make_mesh as j_make_mesh
from icikit.utils.mesh import replicate as j_replicate
from icikit.utils.mesh import shard_along as j_shard
from icikit_torch import parallel as tp
from icikit_torch.models.sort import sort
from icikit_torch.parallel import transport
from icikit_torch.utils.mesh import UnsupportedMeshError, make_mesh

PS = (1, 2, 3, 4, 5, 6, 8)
COMBOS = tuple((dt, op) for op in ("sum", "max", "min")
               for dt in ("int32", "float32"))

FAMILIES = {
    # family: (JAX fn, port fn, variants, per-rank shape of a p-rank case)
    "allgather": (jp.all_gather_blocks, tp.all_gather_blocks,
                  jp.ALLGATHER_ALGORITHMS, lambda p: (5,)),
    "alltoall": (jp.all_to_all_blocks, tp.all_to_all_blocks,
                 jp.ALLTOALL_ALGORITHMS, lambda p: (p, 3)),
    "allreduce": (jp.all_reduce, tp.all_reduce,
                  jp.ALLREDUCE_ALGORITHMS, lambda p: (10,)),
    "reducescatter": (jp.reduce_scatter, tp.reduce_scatter,
                      jp.REDUCESCATTER_ALGORITHMS, lambda p: (3 * p,)),
    "scan": (jp.scan_reduce, tp.scan_reduce, jp.SCAN_ALGORITHMS,
             lambda p: (5,)),
    "broadcast": (jp.broadcast, tp.broadcast,
                  ("ring", "binomial", "xla"), lambda p: (7,)),
    "scatter": (jp.scatter_blocks, tp.scatter_blocks,
                ("linear", "binomial", "xla"), lambda p: (4,)),
    "gather": (jp.gather_blocks, tp.gather_blocks,
               ("linear", "binomial", "xla"), lambda p: (4,)),
    "reduce": (jp.reduce_to_root, tp.reduce_to_root,
               jp.REDUCE_ALGORITHMS, lambda p: (6,)),
}
REDUCTIONS = ("allreduce", "reducescatter", "scan", "reduce")
ROOTED = ("broadcast", "scatter", "gather", "reduce")
ROOTS = (0, 3, 7)
POW2_ONLY = {("allgather", "recursive_doubling"), ("alltoall", "ecube"),
             ("alltoall", "hypercube"), ("allreduce", "recursive_doubling"),
             ("reducescatter", "recursive_halving"), ("scatter", "binomial"),
             ("gather", "binomial")}


def _cases(family):
    """(variant, p, dtype, extra kwargs) for one family: each p a case
    (JAX's refusals included), the dtype/op combination cycling over
    the p's the variant accepts; at p = 8 the combinations a
    power-of-two variant has no p left for, and the roots 0, 3 and 7."""
    out = []
    for variant in FAMILIES[family][2]:
        accepted = ((1, 2, 4, 8) if (family, variant) in POW2_ONLY else PS)
        for p in PS:
            k = accepted.index(p) if p in accepted else 0
            if p != 8:
                picks = (k,)
            elif family in ROOTED:
                picks = range(k, k + 3)
            elif family in REDUCTIONS:
                picks = range(k, max(k + 1, 6))
            else:
                picks = (k,)
            for n, j in enumerate(picks):
                if family in REDUCTIONS:
                    dt, op = COMBOS[(j + 1) % 6]
                    kw = {"op": op}
                else:
                    dt, kw = ("int32", "float32")[j % 2], {}
                if family in ROOTED:
                    kw["root"] = ROOTS[n % 3] if p == 8 else (p - 1) * (k % 2)
                if family == "scan":
                    kw["inclusive"] = j % 3 != 2
                out.append((variant, p, dt, kw))
    return out


def _data(shape, dtype, seed, positive=False):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(-1000, 1000, shape).astype(np.int32)
    return rng.uniform(0.5 if positive else -2.0, 2.0, shape).astype(
        np.float32)


def _same(got: torch.Tensor, want, rtol=None):
    got = np.ascontiguousarray(got.numpy())
    want = np.ascontiguousarray(np.asarray(want))
    assert got.shape == want.shape and got.dtype == want.dtype
    if rtol is not None:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0)
    else:
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


def _both(family, variant, p, data, kw):
    """(port output, JAX output), or (None, None) after checking that
    both raise UnsupportedMeshError."""
    j_fn, t_fn = FAMILIES[family][:2]
    jm = j_make_mesh(p)
    place = j_replicate if family == "scatter" else j_shard
    jx = place(jnp.asarray(data), jm)
    tm = make_mesh(p, device="cpu")
    try:
        want = j_fn(jx, jm, algorithm=variant, **kw)
    except JUnsupported:
        with pytest.raises(UnsupportedMeshError):
            t_fn(torch.from_numpy(data), tm, algorithm=variant, **kw)
        return None, None
    return t_fn(torch.from_numpy(data), tm, algorithm=variant, **kw), want


def _check(family, variant, p, dtype, kw, seed):
    op = kw.get("op", "sum")
    vendor_sum = (variant == "xla" and dtype == "float32" and op == "sum"
                  and family in REDUCTIONS)
    shape = (p,) + FAMILIES[family][3](p)
    data = _data(shape, dtype, seed, positive=vendor_sum)
    got, want = _both(family, variant, p, data, kw)
    if got is not None:
        _same(got, want, rtol=1e-6 if vendor_sum else None)


def _ids(cases):
    return [f"{v}-p{p}-{dt}-" + "-".join(f"{k}{w}" for k, w in kw.items())
            for v, p, dt, kw in cases]


def _parity(family):
    cases = _cases(family)
    return pytest.mark.parametrize("variant,p,dtype,kw", cases,
                                   ids=_ids(cases))


@_parity("allgather")
def test_allgather_parity(variant, p, dtype, kw):
    _check("allgather", variant, p, dtype, kw, seed=p)


@_parity("alltoall")
def test_alltoall_parity(variant, p, dtype, kw):
    _check("alltoall", variant, p, dtype, kw, seed=10 + p)


@_parity("allreduce")
def test_allreduce_parity(variant, p, dtype, kw):
    _check("allreduce", variant, p, dtype, kw, seed=20 + p)


@_parity("reducescatter")
def test_reducescatter_parity(variant, p, dtype, kw):
    _check("reducescatter", variant, p, dtype, kw, seed=30 + p)


@_parity("scan")
def test_scan_parity(variant, p, dtype, kw):
    _check("scan", variant, p, dtype, kw, seed=40 + p)


@_parity("broadcast")
def test_broadcast_parity(variant, p, dtype, kw):
    _check("broadcast", variant, p, dtype, kw, seed=50 + p)


@_parity("scatter")
def test_scatter_parity(variant, p, dtype, kw):
    _check("scatter", variant, p, dtype, kw, seed=60 + p)


@_parity("gather")
def test_gather_parity(variant, p, dtype, kw):
    _check("gather", variant, p, dtype, kw, seed=70 + p)


@_parity("reduce")
def test_reduce_parity(variant, p, dtype, kw):
    _check("reduce", variant, p, dtype, kw, seed=80 + p)


@pytest.mark.parametrize("family,variant,shape", [
    ("allgather", "recursive_doubling_twins", (6, 2, 3)),
    ("alltoall", "hypercube", (8, 8, 2, 3)),
    ("reducescatter", "recursive_halving", (8, 16, 3)),
    ("allreduce", "ring", (8, 100)),      # m % p != 0: the pad path
    ("allreduce", "ring", (8, 100, 2)),
])
def test_multi_dim_and_pad(family, variant, shape):
    data = _data(shape, "float32", seed=90)
    got, want = _both(family, variant, shape[0], data, {})
    _same(got, want)


@pytest.mark.parametrize("family", ["allgather", "alltoall", "allreduce",
                                    "reducescatter", "scan"])
def test_checked_is_refused_until_ported(family):
    fn = FAMILIES[family][1]
    x = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="A5"):
        fn(x, make_mesh(4, device="cpu"), checked=True)


def test_registry_names_match_jax():
    from icikit.utils.registry import list_algorithms as j_list
    from icikit_torch.utils.registry import list_algorithms as t_list
    families = sorted(FAMILIES)
    assert sum(len(t_list(f)) for f in families) == 31
    for f in families:
        assert t_list(f) == j_list(f)


# -- located reductions and top-k -------------------------------------


def _loc_data(p, n, seed, dtype="int32"):
    if dtype == "int32":
        return _data((p, n), "int32", seed)
    return np.random.default_rng(seed).standard_normal((p, n)).astype(
        np.float32)


@pytest.mark.parametrize("p,op,dtype,ties", [
    (8, "maxloc", "int32", False), (8, "minloc", "int32", False),
    (8, "maxloc", "int32", True), (8, "minloc", "float32", False),
    (3, "maxloc", "int32", True), (5, "minloc", "int32", True),
    (1, "maxloc", "float32", False),
])
def test_reduceloc_allreduce_loc_parity(p, op, dtype, ties):
    data = _loc_data(p, 4, seed=p, dtype=dtype)
    if ties:  # the extremum on two ranks: the lower global index wins
        v = data.max() + 1 if op == "maxloc" else data.min() - 1
        data[p // 2, 3] = v
        data[p - 1, 1] = v
        data[0, 2] = v
    jm = j_make_mesh(p)
    jv, ji = jp.allreduce_loc(j_shard(jnp.asarray(data), jm), jm, op=op)
    tv, ti = tp.allreduce_loc(torch.from_numpy(data),
                              make_mesh(p, device="cpu"), op=op)
    _same(tv, jv)
    _same(ti, ji)


@pytest.mark.parametrize("k,largest,p", [(1, True, 8), (3, True, 8),
                                         (8, True, 8), (1, False, 8),
                                         (3, False, 8), (8, False, 8),
                                         (4, True, 3), (2, False, 6)])
def test_reduceloc_top_k_dist_parity(k, largest, p):
    # few distinct values: ties inside and across ranks
    data = np.random.default_rng(k + p).integers(0, 6, (p, 16)).astype(
        np.int32)
    jm = j_make_mesh(p)
    jv, ji = jp.top_k_dist(j_shard(jnp.asarray(data), jm), jm, k,
                           largest=largest)
    tv, ti = tp.top_k_dist(torch.from_numpy(data),
                           make_mesh(p, device="cpu"), k, largest=largest)
    _same(tv, jv)
    _same(ti, ji)


def test_reduceloc_top_k_smallest_keeps_int_min():
    data = np.full((8, 4), 5, np.int32)
    data[3, 2] = np.iinfo(np.int32).min
    data[6, 0] = np.iinfo(np.int32).max
    jm = j_make_mesh(8)
    jv, ji = jp.top_k_dist(j_shard(jnp.asarray(data), jm), jm, 3,
                           largest=False)
    tv, ti = tp.top_k_dist(torch.from_numpy(data),
                           make_mesh(8, device="cpu"), 3, largest=False)
    _same(tv, jv)
    _same(ti, ji)
    assert int(tv[0]) == np.iinfo(np.int32).min and int(ti[0]) == 14


def test_reduceloc_validates():
    m = make_mesh(8, device="cpu")
    x = torch.zeros((8, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="maxloc"):
        tp.allreduce_loc(x, m, op="sum")
    with pytest.raises(ValueError, match="exceeds the per-device"):
        tp.top_k_dist(x, m, k=5)
    with pytest.raises(ValueError, match="k must be"):
        tp.top_k_dist(x, m, k=0)
    with pytest.raises(ValueError, match="one .* block per device"):
        tp.allreduce_loc(torch.zeros((16, 4)), m)


# -- the transport ----------------------------------------------------


def test_transport_partial_perm_zero_fills_and_full_perm_gathers():
    a = torch.arange(1, 25, dtype=torch.float32).reshape(6, 4)
    out = transport.ppermute(a, [(0, 2), (5, 4)])
    assert torch.equal(out[2], a[0]) and torch.equal(out[4], a[5])
    assert not out[[0, 1, 3, 5]].any()
    assert not transport.ppermute(a, []).any()
    full = transport.ppermute(a, [(j, (j + 2) % 6) for j in range(6)])
    assert torch.equal(full, torch.roll(a, 2, 0))


def test_transport_reuses_its_index_tensors():
    """A second call of the same schedule builds no index tensor: on the
    card each build would be a host-to-device copy."""
    m = make_mesh(8, device="cpu")
    x = torch.arange(8 * 24, dtype=torch.int32).reshape(8, 24)
    tp.all_reduce(x, m, algorithm="ring")
    tp.all_gather_blocks(x, m, algorithm="recursive_doubling")
    before = transport.index.cache_info()
    tp.all_reduce(x, m, algorithm="ring")
    tp.all_gather_blocks(x, m, algorithm="recursive_doubling")
    after = transport.index.cache_info()
    assert after.misses == before.misses and after.hits > before.hits
    calls = []
    orig = torch.tensor
    try:
        torch.tensor = lambda *a, **k: calls.append(a) or orig(*a, **k)
        tp.all_reduce(x, m, algorithm="ring")
    finally:
        torch.tensor = orig
    assert calls == []


@pytest.mark.parametrize("p", [2, 4, 8])
def test_bitonic_sort_still_matches_jax(p):
    x = np.random.default_rng(p).integers(-2**31, 2**31 - 1, 1 << 12,
                                          dtype=np.int64).astype(np.int32)
    want = np.asarray(j_sort(jnp.asarray(x), j_make_mesh(p),
                             algorithm="bitonic"))
    got = sort(torch.from_numpy(x), make_mesh(p, device="cpu"),
               algorithm="bitonic")
    _same(got, want)
