"""icikit_torch's four-sort study and capacity study on the CPU.

``sweep_sorts`` and ``main --device cpu`` verify every algorithm (0
inversions and equal to ``torch.sort``), as ``tests/test_bench_sort.py``
holds JAX's study; the capacity study's overflow table equals JAX's
``_overflowed`` on the same numpy keys, factor by factor; and
``timeit_chained`` keeps JAX's two-point protocol.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from icikit.bench import capacity as jcap
from icikit.models.sort.common import prepare_blocks as j_prepare_blocks
from icikit.utils.mesh import make_mesh as j_make_mesh
from icikit.utils.prandom import odd_dist_warp as j_odd_dist_warp
from icikit_torch.bench import capacity as tcap
from icikit_torch.bench.sort import (SortRecord, failed, format_table, main,
                                     study_chain, study_keys, sweep_sorts)
from icikit_torch.interop import from_jax
from icikit_torch.models.sort.common import prepare_blocks
from icikit_torch.utils.mesh import make_mesh
from icikit_torch.utils.timing import timeit_chained

ALL = {"bitonic", "sample", "sample_bitonic", "quicksort"}


@pytest.mark.parametrize("odd_dist", [False, True])
def test_sweep_sorts_all_algorithms(odd_dist):
    records = sweep_sorts(make_mesh(8, device="cpu"), sizes=(4096,),
                          runs=2, warmup=1, odd_dist=odd_dist, windows=1)
    assert {r.algorithm for r in records} == ALL
    for r in records:
        assert r.errors == 0 and r.matches_torch_sort and not failed(r)
        assert r.keys_per_s > 0 and r.p == 8
        assert r.distribution == ("odd_dist" if odd_dist else "uniform")
        # CPU tensors launch no kernel; the default capacities hold
        assert r.launches == {"net": 0, "cross": 0}
        assert r.retries == {"sample": 0, "quicksort": 0}
        assert r.timed_runs >= 3 and set(r.timed_retries) == {
            "sample", "quicksort"}
        assert r.torch_sort_s > 0 and r.floor_s is None
        assert r.device == "cpu"
    table = format_table(records)
    assert "bitonic" in table and "Mkeys/s" in table


def test_sweep_sorts_float_and_non_pow2_skip():
    records = sweep_sorts(make_mesh(6, device="cpu"), sizes=(4096,),
                          runs=2, warmup=1, dtype="float32", windows=0)
    # bitonic, sample_bitonic and quicksort need a power-of-2 p
    assert {r.algorithm for r in records} == {"sample"}
    assert all(r.errors == 0 and r.dtype == "float32" for r in records)
    assert records[0].protocol == "verified, not timed"
    assert records[0].timed_runs == 0


def test_sweep_sorts_median_of_windows_and_bf16():
    records = sweep_sorts(make_mesh(4, device="cpu"), sizes=(3000,),
                          algorithms=["sample", "quicksort"], runs=1,
                          warmup=1, dtype="bfloat16", odd_dist=True,
                          windows=2)
    assert [r.algorithm for r in records] == ["sample", "quicksort"]
    for r in records:
        assert r.protocol == "median-of-windows" and r.windows >= 2
        assert r.min_s <= r.mean_s <= r.max_s and not failed(r)
    rec = json.loads(records[0].to_json())
    assert rec["dtype"] == "bfloat16" and rec["launches"] is not None


def test_failed_flags_inversions_and_oracle_mismatch():
    base = dict(algorithm="sample", p=8, n=16, dtype="int32",
                distribution="uniform", runs=1, mean_s=1.0, best_s=1.0,
                keys_per_s=16.0)
    assert not failed(SortRecord(errors=0, matches_torch_sort=True, **base))
    assert failed(SortRecord(errors=1, matches_torch_sort=True, **base))
    assert failed(SortRecord(errors=0, matches_torch_sort=False, **base))


def test_main_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "rec.jsonl"
    rc = main(["--device", "cpu", "--sizes", "4096,1000", "--windows", "1",
               "--runs", "1", "--json", str(out)])
    assert rc == 0
    lines = out.read_text().splitlines()
    assert len(lines) == 8
    assert {json.loads(x)["algorithm"] for x in lines} == ALL
    assert "device: cpu" in capsys.readouterr().out


def test_odd_dist_chain_gathers_integer_keys_at_the_minimum():
    """The reference's chain under odd_dist maps its smallest draws to
    the int32 minimum, which the scramble keeps: the share of keys there
    grows run by run, which the records' timed retries show."""
    keys = study_keys(1 << 16, torch.int32, True, device="cpu")
    chain = study_chain(torch.int32, True)
    shares = []
    for _ in range(4):
        shares.append(float((keys == -2**31).double().mean()))
        (keys,) = chain((keys,), torch.sort(keys).values)
    assert all(b > a + 0.02 for a, b in zip(shares, shares[1:]))


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("odd_dist", [False, True])
def test_study_keys_and_chain(dtype, odd_dist):
    """The keys span the dtype's range (integers) or [0, 1); the chain
    keeps shape and dtype and changes the keys every run."""
    keys = study_keys(4096, dtype, odd_dist, device="cpu")
    assert keys.dtype == dtype and keys.shape == (4096,)
    if dtype == torch.int32:
        assert int(keys.min()) < -2**30 or odd_dist
        assert int(keys.max()) > 2**30
    else:
        assert 0.0 <= float(keys.min()) and float(keys.max()) <= 1.0
    (nxt,) = study_chain(dtype, odd_dist)((keys,), torch.sort(keys).values)
    assert nxt.dtype == dtype and nxt.shape == keys.shape
    assert not torch.equal(nxt, torch.sort(keys).values)
    if not odd_dist and dtype == torch.int32:
        # the odd multiplier is a bijection of int32
        assert torch.unique(nxt).numel() == torch.unique(keys).numel()


def _cap_keys(n, dist):
    u = np.random.default_rng(n).random(n).astype(np.float32)
    if dist == "odd":
        u = np.asarray(j_odd_dist_warp(jnp.asarray(u)))
    return (u * 2e9 - 1e9).astype(np.int32)


@pytest.mark.parametrize("p", [4, 8])
@pytest.mark.parametrize("dist", ["uniform", "odd"])
def test_capacity_table_matches_reference(p, dist):
    n = 1 << 13
    x = _cap_keys(n, dist)
    jmesh = j_make_mesh(p)
    jx, n_loc = j_prepare_blocks(jnp.asarray(x), jmesh)
    tx, _ = prepare_blocks(from_jax(x), make_mesh(p, device="cpu"))
    want = {(a, f): jcap._overflowed(a, jmesh, jx, n_loc, p, f)
            for a in jcap.ALGS for f in jcap.FACTORS}
    got = {(a, f): tcap.overflowed(a, tx, n_loc, p, f)
           for a in tcap.ALGS for f in tcap.FACTORS}
    assert got == want
    assert tcap.FACTORS == jcap.FACTORS and tcap.ALGS == jcap.ALGS


def test_capacity_study_cli(tmp_path):
    out = tmp_path / "cap.json"
    assert tcap.main(["--ns", "12", "--ps", "4", "--device", "cpu",
                      "--out", str(out)]) == 0
    recs = json.loads(out.read_text())
    assert len(recs) == 2 * len(tcap.ALGS)
    assert all(r["min_factor"] in tcap.FACTORS for r in recs)


def test_timeit_chained_two_point():
    calls = []

    def fn(x):
        calls.append(1)
        return x + 1

    res = timeit_chained(fn, (torch.zeros(4),), lambda a, o: (o,), runs=2,
                         warmup=1, target_window_s=0.0)
    assert res.mean_s > 0 and res.runs >= 4
    assert len(res.per_run_s) == res.runs
    # warmup, then windows of 2 and 4 runs
    assert len(calls) >= 1 + 2 + 4
