"""icikit_torch's checked transport against icikit.parallel.integrity.

The same numpy inputs, made from a seed, go through the JAX package on
the simulated CPU mesh (``make_mesh(p)``) and through the port on a CPU
``RankMesh(p)``: the checksum fold per rank row (bitwise, JAX's
``segment_checksum`` of that rank's block), the corruption site
(``traced_flip`` against JAX's under ``shard_map``), the step counts
(``steps_of``, which the chaos taint hash needs before the first
attempt), the checked outputs, and the drill verdicts (the quarantine
ledger, ``stats()`` and the obs events), with the same ``FaultPlan`` in
each package's ``chaos``. Tolerance: exact everywhere (bits, counts,
ranks and steps).

The chaos decisions themselves are held in ``tests/test_torch_chaos.py``.
"""

from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from icikit import chaos as j_chaos
from icikit import obs as j_obs
from icikit import parallel as jp
from icikit.models.sort import sort as j_sort
from icikit.models.sort.bitonic import build_checked as j_build_sort
from icikit.models.sort.common import prepare_blocks as j_prepare_blocks
from icikit.parallel import integrity as j_integrity
from icikit.parallel import transport as j_transport
from icikit.parallel.shmap import shard_map
from icikit.utils.mesh import UnsupportedMeshError as JUnsupported
from icikit.utils.mesh import make_mesh as j_make_mesh
from icikit.utils.mesh import shard_along as j_shard
from icikit.utils.registry import list_algorithms
from icikit_torch import chaos, obs
from icikit_torch import parallel as tp
from icikit_torch.models.sort import sort
from icikit_torch.models.sort.bitonic import exchange_steps
from icikit_torch.ops.cuda_integrity import (segment_checksum,
                                             segment_checksum_plain)
from icikit_torch.parallel import integrity, transport
from icikit_torch.utils.mesh import UnsupportedMeshError, make_mesh

DTYPES = ("int32", "float32", "float16", "bfloat16", "int8", "uint8",
          "bool")
LENGTHS = (0, 1, 33, 4096)
ROWS = 3

# family: (JAX entry, port entry, per-case shape at p ranks, kwargs)
FAMILIES = {
    "allgather": (jp.all_gather_blocks, tp.all_gather_blocks,
                  lambda p: (p, 5), {}),
    "alltoall": (jp.all_to_all_blocks, tp.all_to_all_blocks,
                 lambda p: (p, p, 3), {}),
    "allreduce": (jp.all_reduce, tp.all_reduce, lambda p: (p, 10),
                  {"op": "sum"}),
    "reducescatter": (jp.reduce_scatter, tp.reduce_scatter,
                      lambda p: (p, 3 * p), {"op": "max"}),
    "scan": (jp.scan_reduce, tp.scan_reduce, lambda p: (p, 5),
             {"op": "sum", "inclusive": True}),
}
PS = (1, 2, 3, 4, 5, 8)


def _raw_rows(dtype: str, n: int, seed: int):
    """(numpy (ROWS, n) of ``dtype``, the same bits as a jax array)."""
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        a = rng.integers(0, 2, (ROWS, n)).astype(bool)
        return a, jnp.asarray(a)
    if dtype == "bfloat16":
        a = rng.integers(0, 1 << 16, (ROWS, n)).astype(np.uint16)
        return a, jnp.asarray(a).view(jnp.bfloat16)
    item = np.dtype(dtype).itemsize
    a = rng.integers(0, 256, ROWS * n * item).astype(np.uint8).view(
        dtype).reshape(ROWS, n)
    return a, jnp.asarray(a)


def _torch_of(a: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


# -- the fold ---------------------------------------------------------


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_checksum_matches_jax_per_row(dtype, n):
    a, j = _raw_rows(dtype, n, seed=len(dtype) * 100 + n)
    want = np.asarray(jax.vmap(j_transport.segment_checksum)(j))
    got = segment_checksum(_torch_of(a, dtype))
    assert got.dtype == torch.int32 and got.shape == (ROWS,)
    assert np.array_equal(got.numpy().view(np.uint32),
                          want.astype(np.uint32))
    # the same rows as trailing dims: the fold reads a row's flat order
    if n == 4096:
        t = _torch_of(a, dtype).reshape(ROWS, 64, 8, 8)
        assert torch.equal(segment_checksum(t), got)


@pytest.mark.parametrize("dtype", DTYPES[:-1])
def test_every_single_bit_flip_changes_the_fold(dtype):
    """All 384 one-bit flips of a 48-byte row, one row each: every fold
    differs from the clean row's (detection cannot miss), and the clean
    fold is the same twice (no false positive)."""
    rng = np.random.default_rng(7)
    raw = rng.integers(0, 256, 48).astype(np.uint8)
    flips = np.repeat(raw[None], 48 * 8, axis=0)
    for b in range(48 * 8):
        flips[b, b // 8] ^= np.uint8(1 << (b % 8))
    as_t = (lambda u: torch.from_numpy(u).view(
        {"int32": torch.int32, "float32": torch.float32,
         "float16": torch.float16, "bfloat16": torch.bfloat16,
         "int8": torch.int8, "uint8": torch.uint8}[dtype]))
    clean = segment_checksum(as_t(raw[None].copy()))
    assert torch.equal(clean, segment_checksum(as_t(raw[None].copy())))
    folds = segment_checksum(as_t(flips))
    assert not bool((folds == clean).any())


@pytest.mark.parametrize("dtype", [torch.int64, torch.float64])
def test_64_bit_lanes_fold_high_xor_low(dtype):
    """JAX's x64 is off in this suite, so the 8-byte fold is held to a
    numpy reference written here: lane = high ^ low, rotated by the
    position mod 32, XOR-reduced."""
    rng = np.random.default_rng(64)
    u = rng.integers(0, 2**63, (ROWS, 37), dtype=np.uint64) * np.uint64(2) \
        + rng.integers(0, 2, (ROWS, 37), dtype=np.uint64)
    lanes = ((u >> np.uint64(32)) ^ u).astype(np.uint32)
    s = (np.arange(37) % 32).astype(np.uint32)
    rot = (lanes << s) | (lanes >> ((np.uint32(32) - s) & np.uint32(31)))
    want = np.bitwise_xor.reduce(rot, axis=1)
    t = torch.from_numpy(u.view(np.int64)).view(dtype)
    assert np.array_equal(segment_checksum(t).numpy().view(np.uint32),
                          want)


def test_plain_fold_is_the_cpu_route_and_refuses_other_devices():
    x = torch.arange(40, dtype=torch.int32).reshape(4, 10)
    assert torch.equal(segment_checksum(x), segment_checksum_plain(x))
    assert torch.equal(segment_checksum(x, plain=True),
                       segment_checksum_plain(x))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        segment_checksum(x.to("meta"))
    assert segment_checksum(torch.zeros((2, 0))).tolist() == [0, 0]


# -- the corruption site ----------------------------------------------


def _bits(a: np.ndarray) -> np.ndarray:
    """The elements' bits as unsigned ints (NaN payloads compare)."""
    return a.view(f"uint{8 * a.itemsize}")


def _j_flip(x, taint, idx, p):
    mesh = j_make_mesh(p)
    f = jax.jit(shard_map(
        lambda b, t: j_transport.traced_flip(b, t, idx, "p"), mesh=mesh,
        in_specs=(P("p"), P()), out_specs=P("p")))
    return np.asarray(f(j_shard(x, mesh), jnp.asarray(taint)))


TAINTS = (tuple(j_chaos.TAINT_OFF), (0, 2, 12345, 31), (0, 0, 7, 3),
          (1, 2, 5, 0), (0, 3, (1 << 30) - 1, 17))


@pytest.mark.parametrize("dtype", DTYPES)
def test_traced_flip_matches_jax(dtype):
    p, n = 4, 33
    a, _ = _raw_rows(dtype, n * p // ROWS + 1, seed=5)
    a = np.ascontiguousarray(a.reshape(-1)[: p * n].reshape(p, n))
    j = (jnp.asarray(a).view(jnp.bfloat16) if dtype == "bfloat16"
         else jnp.asarray(a))
    for taint in TAINTS:
        taint = np.asarray(taint, np.int32)
        want = _j_flip(j, taint, 0, p)
        x = _torch_of(a, dtype).clone()
        got = transport.traced_flip(x, taint, 0)
        g = _bits(got.view(torch.int16).numpy() if dtype == "bfloat16"
                  else got.numpy())
        assert np.array_equal(g, _bits(want)), (dtype, taint)
        flipped = int((g != _bits(a)).sum())
        assert flipped == (taint[0] == 0 and dtype != "bool") or (
            dtype == "bool" and flipped <= 1)
    # cold: the very tensor back, untouched
    x = _torch_of(a, dtype).clone()
    assert transport.traced_flip(x, chaos.TAINT_OFF, 0) is x


# -- step counts -------------------------------------------------------


def _extra(family, kw):
    if family == "scan":
        return (kw["op"], bool(kw["inclusive"]))
    return (kw["op"],) if "op" in kw else ()


def _steps_cases():
    out = []
    for family in FAMILIES:
        for alg in list_algorithms(family):
            if alg != "xla":
                out.append((family, alg))
    return out


@pytest.mark.parametrize("family,alg", _steps_cases())
def test_steps_of_matches_jax(family, alg):
    shape_of, kw = FAMILIES[family][2], FAMILIES[family][3]
    kws = [kw] + ([dict(kw, inclusive=False)] if family == "scan" else [])
    for p in PS:
        for k in kws:
            x = np.zeros(shape_of(p), np.int32)
            mesh = j_make_mesh(p)
            try:
                prog, box = j_integrity._build_checked(
                    family, alg, mesh, "p", _extra(family, k))
                want = j_integrity.steps_of(prog, box, x)
            except JUnsupported:
                with pytest.raises(UnsupportedMeshError):
                    FAMILIES[family][1](torch.from_numpy(x),
                                        make_mesh(p, device="cpu"),
                                        algorithm=alg, checked=True, **k)
                continue
            inner = tp.shmap.family_body(family, alg, p, *_extra(family, k))
            got = integrity.steps_of(("test", family, alg, p, x.shape,
                                      _extra(family, k)), inner,
                                     torch.from_numpy(x))
            assert got == want, (family, alg, p, k)


def test_sort_steps_match_jax():
    for p in (1, 2, 4, 8):
        mesh = j_make_mesh(p)
        blocks, _ = j_prepare_blocks(jnp.arange(64, dtype=jnp.int32), mesh)
        prog, box = j_build_sort(mesh, "p")
        assert exchange_steps(p) == j_integrity.steps_of(prog, box, blocks)
    with pytest.raises(UnsupportedMeshError):
        exchange_steps(6)


def test_steps_of_consumes_no_chaos_decision():
    integrity._STEPS.clear()
    plan = chaos.FaultPlan(rates={"corrupt:collective.*": 1.0})
    with chaos.inject(plan):
        integrity.steps_of(("c",), tp.shmap.family_body(
            "allreduce", "ring", 4, "sum"), torch.zeros((4, 8)))
    assert plan.log == [] and plan._counts == {}


# -- checked outputs ----------------------------------------------------


def _checked_cases():
    """A seeded subset: each family with each of its non-xla variants
    once, at a p the variant takes, int32 or float32."""
    rng = np.random.default_rng(2024)
    out = []
    for family, alg in _steps_cases():
        pool = (2, 4, 8) if alg in ("recursive_doubling", "ecube",
                                    "hypercube", "recursive_halving") \
            else (3, 5, 8)
        out.append((family, alg, int(rng.choice(pool)),
                    ("int32", "float32")[int(rng.integers(2))]))
    return out


def _data(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(-1000, 1000, shape).astype(np.int32)
    return rng.uniform(-2, 2, shape).astype(np.float32)


@pytest.mark.parametrize("family,alg,p,dtype", _checked_cases())
def test_checked_output_matches_jax_and_unchecked(family, alg, p, dtype):
    j_fn, t_fn, shape_of, kw = FAMILIES[family]
    data = _data(shape_of(p), dtype, seed=p * 7 + len(alg))
    jm = j_make_mesh(p)
    want = np.asarray(j_fn(j_shard(jnp.asarray(data), jm), jm,
                           algorithm=alg, checked=True, **kw))
    tm = make_mesh(p, device="cpu")
    got = t_fn(torch.from_numpy(data), tm, algorithm=alg, checked=True,
               **kw)
    plain = t_fn(torch.from_numpy(data), tm, algorithm=alg, **kw)
    assert np.array_equal(got.numpy().view(np.uint8), want.view(np.uint8))
    assert torch.equal(got.view(torch.uint8), plain.view(torch.uint8))


# -- drills ------------------------------------------------------------


def _drill(family, alg, p, plan_kw, retries=2, kw=None):
    """One drill in each package under the same plan: (JAX's (out, stats,
    quarantine, log, events, counters), the port's)."""
    j_fn, t_fn, shape_of, fkw = FAMILIES[family]
    kw = fkw if kw is None else kw
    data = _data(shape_of(p), "int32", seed=99 + p)
    jm = j_make_mesh(p)
    jx = j_shard(jnp.asarray(data), jm)
    res = []
    for pkg_chaos, pkg_obs, pkg_int, run in (
            (j_chaos, j_obs, j_integrity,
             lambda: np.asarray(j_fn(jx, jm, algorithm=alg, checked=True,
                                     retries=retries, **kw))),
            (chaos, obs, integrity,
             lambda: t_fn(torch.from_numpy(data),
                          make_mesh(p, device="cpu"), algorithm=alg,
                          checked=True, retries=retries, **kw).numpy())):
        pkg_int.reset_stats()
        plan = pkg_chaos.FaultPlan(**plan_kw)
        ring = pkg_obs.RingSink()
        reg = pkg_obs.enable_metrics()
        err = None
        try:
            with pkg_obs.installed(ring), pkg_chaos.inject(plan):
                out = run()
        except Exception as e:  # noqa: BLE001 - compared across packages
            out, err = None, type(e).__name__
        finally:
            pkg_obs.disable_metrics()
        res.append((out, err, pkg_int.stats(), pkg_int.quarantine_counts(),
                    sorted(plan.log), ring.events,
                    reg.snapshot()["counters"]))
    return res


DRILLS = (("allgather", "ring", 4), ("allgather", "recursive_doubling_twins",
                                     5),
          ("alltoall", "hypercube", 8), ("allreduce", "ring", 8),
          ("allreduce", "recursive_doubling", 4),
          ("reducescatter", "pairwise", 3), ("scan", "linear", 5))


@pytest.mark.parametrize("family,alg,p", DRILLS)
def test_scheduled_drill_matches_jax(family, alg, p):
    site = f"corrupt:collective.{family}"
    (jo, jerr, jst, jq, jlog, jev, jc), (to, terr, tst, tq, tlog, tev, tc) \
        = _drill(family, alg, p, dict(seed=p + 11, schedule={site: (0, 2)}))
    assert jerr is terr is None
    assert np.array_equal(to.view(np.uint8), jo.view(np.uint8))
    assert tst == jst and tq == jq and tlog == jlog
    assert tst["detected"] == 1 and tst["recoveries"] == 1
    assert len(tst["last"]["devices"]) == 1 == len(tst["last"]["steps"])
    assert tev == jev and tc == jc


def test_scheduled_exclusive_scan_drill_matches_jax():
    kw = {"op": "min", "inclusive": False}
    j, t = _drill("scan", "hillis_steele", 8,
                  dict(seed=4, schedule={"corrupt:collective.scan": (0,)}),
                  kw=kw)
    assert np.array_equal(t[0], j[0]) and t[2:6] == j[2:6]


def test_rate_one_exhausts_retries_in_both():
    j, t = _drill("allgather", "ring", 4,
                  dict(rates={"corrupt:collective.allgather": 1.0}),
                  retries=2)
    assert j[1] == t[1] == "IntegrityError"
    assert len(t[4]) == len(j[4]) == 3            # retries + 1 fired
    assert t[2] == j[2] and t[2]["detected"] == 3 and t[2]["retries"] == 2
    assert t[3] == j[3] and t[5] == j[5] and t[6] == j[6]


def test_rate_drill_over_calls_matches_jax():
    """A rate plan over several calls: which attempts fire follows the
    blake2b stream, the same in both packages."""
    res = []
    for pkg_chaos, pkg_int, call in (
            (j_chaos, j_integrity, lambda x, m: np.asarray(jp.all_reduce(
                j_shard(jnp.asarray(x), m), m, algorithm="ring",
                checked=True, retries=3))),
            (chaos, integrity, lambda x, m: tp.all_reduce(
                torch.from_numpy(x), m, algorithm="ring", checked=True,
                retries=3).numpy())):
        mesh = j_make_mesh(4) if pkg_chaos is j_chaos else make_mesh(
            4, device="cpu")
        pkg_int.reset_stats()
        plan = pkg_chaos.FaultPlan(
            seed=17, rates={"corrupt:collective.allreduce": 0.4})
        with pkg_chaos.inject(plan):
            outs = [call(_data((4, 12), "int32", s), mesh)
                    for s in range(6)]
        res.append((outs, sorted(plan.log), pkg_int.stats(),
                    pkg_int.quarantine_counts()))
    (jo, jl, js, jq), (to, tl, ts, tq) = res
    assert all(np.array_equal(a, b) for a, b in zip(jo, to))
    assert tl == jl and ts == js and tq == jq and ts["detected"] > 0


def test_armed_but_cold_plan_is_bit_identical():
    x = torch.from_numpy(_data((8, 64), "float32", 3))
    mesh = make_mesh(8, device="cpu")
    integrity.reset_stats()
    plan = chaos.FaultPlan(rates={"corrupt:collective.*": 0.0})
    with chaos.inject(plan):
        for family in ("allgather", "allreduce", "scan"):
            fn = FAMILIES[family][1]
            a = fn(x, mesh, algorithm="ring" if family != "scan"
                   else "hillis_steele", checked=True)
            b = fn(x, mesh, algorithm="ring" if family != "scan"
                   else "hillis_steele")
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert plan.log == [] and integrity.stats()["detected"] == 0


def test_p1_fired_drill_warns_and_returns_the_payload():
    x = torch.arange(6, dtype=torch.int32).reshape(1, 6)
    plan = chaos.FaultPlan(schedule={"corrupt:collective.allgather": (0,)})
    with chaos.inject(plan), pytest.warns(RuntimeWarning,
                                          match="no exchange steps"):
        out = tp.all_gather_blocks(x, make_mesh(1, device="cpu"),
                                   checked=True)
    assert torch.equal(out, x[None]) and plan.fired("corrupt") == 1


def test_vendor_variants_and_unchecked_families_are_refused():
    x = torch.ones((4, 8), dtype=torch.int32)
    mesh = make_mesh(4, device="cpu")
    for family in integrity.CHECKED_FAMILIES:
        fn, shape_of = FAMILIES[family][1], FAMILIES[family][2]
        with pytest.raises(ValueError, match="vendor"):
            fn(torch.ones(shape_of(4), dtype=torch.int32), mesh,
               algorithm="xla", checked=True)
    with pytest.raises(KeyError):
        tp.all_reduce(x, mesh, algorithm="bogus", checked=True)
    assert integrity.CHECKED_FAMILIES == j_integrity.CHECKED_FAMILIES
    for family in integrity.CHECKED_FAMILIES:
        assert chaos.site_known(f"collective.{family}")


def test_clean_checked_run_makes_no_host_to_device_copy(monkeypatch):
    """The verdict is built on the device (a fill for p = 1, a stack of
    compares otherwise) and the taint never leaves the host: a repeated
    clean call makes no tensor from host data (the CPU proxy of the
    card's trace, which phase 26 of chip_smoke.py reads)."""
    x = torch.from_numpy(_data((8, 16), "int32", 1))
    mesh = make_mesh(8, device="cpu")
    tp.all_reduce(x, mesh, algorithm="ring", checked=True)
    made = []
    real = torch.tensor

    def spy(*a, **k):
        made.append(a)
        return real(*a, **k)

    monkeypatch.setattr(torch, "tensor", spy)
    tp.all_reduce(x, mesh, algorithm="ring", checked=True)
    assert made == []


# -- the checked sort ----------------------------------------------------


def _keys(dtype, n, seed):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)
    return rng.standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("p", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_checked_sort_matches_jax_clean_and_under_a_drill(p, dtype):
    keys = _keys(dtype, 1000 + p, seed=p)
    jm, tm = j_make_mesh(p), make_mesh(p, device="cpu")
    res = []
    for pkg_chaos, pkg_int, run in (
            (j_chaos, j_integrity, lambda c: np.asarray(j_sort(
                jnp.asarray(keys), jm, checked=c))),
            (chaos, integrity, lambda c: sort(
                torch.from_numpy(keys), tm, checked=c).numpy())):
        clean = run(True)
        pkg_int.reset_stats()
        plan = pkg_chaos.FaultPlan(
            seed=p + 3, schedule={"corrupt:sort.bitonic.exchange": (0,)})
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # p = 1
            with pkg_chaos.inject(plan):
                healed = run(True)
        res.append((clean, healed, pkg_int.stats(),
                    pkg_int.quarantine_counts(), sorted(plan.log)))
    (jc, jh, js, jq, jl), (tc, th, ts, tq, tl) = res
    want = np.sort(keys)
    for a in (jc, jh, tc, th):
        assert np.array_equal(a, want)
    assert ts == js and tq == jq and tl == jl
    assert ts["detected"] == (p > 1) and ts["recoveries"] == (p > 1)


@pytest.mark.parametrize("algorithm", ["sample", "sample_bitonic",
                                       "quicksort"])
def test_checked_sort_is_bitonic_only(algorithm):
    x = torch.arange(64, dtype=torch.int32)
    with pytest.raises(ValueError, match="bitonic exchange network only"):
        sort(x, make_mesh(4, device="cpu"), algorithm=algorithm,
             checked=True)
    with pytest.raises(ValueError, match="bitonic exchange network only"):
        j_sort(jnp.asarray(x.numpy()), j_make_mesh(4), algorithm=algorithm,
               checked=True)


# -- the sort's dispatch-boundary chaos sites ------------------------


@pytest.mark.parametrize("algorithm", ["bitonic", "sample",
                                       "sample_bitonic", "quicksort"])
def test_sort_under_a_delay_plan_is_unchanged(algorithm):
    rng = np.random.default_rng(11)
    mesh = make_mesh(4, device="cpu")
    xs = [torch.from_numpy(rng.integers(-1000, 1000, int(n)).astype(
        np.int32)) for n in (7, 129, 500)]
    base = [sort(x, mesh, algorithm=algorithm) for x in xs]
    plan = chaos.FaultPlan(rates={"delay:sort.*": 1.0}, delay_s=0.002)
    with chaos.inject(plan):
        delayed = [sort(x, mesh, algorithm=algorithm) for x in xs]
    assert plan.fired("delay", f"sort.{algorithm}") == len(xs)
    for x, b, d in zip(xs, base, delayed):
        assert torch.equal(d, b)
        assert torch.equal(b, torch.sort(x).values)


def test_sort_die_site_is_consumed_then_clean():
    x = torch.from_numpy(np.random.default_rng(3).integers(0, 100, 64)
                         .astype(np.int32))
    mesh = make_mesh(4, device="cpu")
    plan = chaos.FaultPlan(schedule={"die:sort.bitonic": (0,)})
    with chaos.inject(plan):
        with pytest.raises(chaos.InjectedDeath):
            sort(x, mesh, algorithm="bitonic")
        out = sort(x, mesh, algorithm="bitonic")
    assert plan.fired("die", "sort.bitonic") == 1
    assert torch.equal(out, torch.sort(x).values)
    for a in ("bitonic", "sample", "sample_bitonic", "quicksort"):
        assert chaos.site_known(f"sort.{a}")
    assert chaos.site_known("sort.bitonic.exchange")
