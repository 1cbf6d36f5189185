"""icikit_torch's collective bench harness and CLI against
icikit.bench.harness.

The harness's normalisations and record format are JAX's (``_bus_bytes``
equal for every family, p and size; ``BenchRecord``'s JSON keys); its
payload is JAX's ``_pattern`` value for value; every record of a CPU
sweep verifies, and the port's outputs pass JAX's own closed-form
``verify`` (a numpy oracle, so no JAX program runs); a flipped bit in
an output fails the port's ``verify``. The CLI exits 0 on a verified
sweep and refuses ``--checked``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from icikit.bench import harness as jh
from icikit.utils.mesh import make_mesh as j_make_mesh
from icikit_torch.bench import harness as th
from icikit_torch.utils.mesh import UnsupportedMeshError, make_mesh
from icikit_torch.utils.registry import list_algorithms

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("family", th.FAMILIES)
def test_bus_bytes_match_jax(family):
    for p in (1, 2, 3, 5, 6, 8, 64):
        for block_bytes in (1, 4, 4096, 1 << 26):
            assert th._bus_bytes(family, p, block_bytes) == \
                jh._bus_bytes(family, p, block_bytes)


def test_reference_sweeps_and_record_keys_match_jax():
    assert th.REFERENCE_SWEEP == jh.REFERENCE_SWEEP
    assert th.REFERENCE_SWEEP_PERSONALIZED == jh.REFERENCE_SWEEP_PERSONALIZED
    fields = [f.name for f in dataclasses.fields(jh.BenchRecord)]
    rec = th.BenchRecord(family="allreduce", algorithm="ring", p=8,
                         msize=16, dtype="int32", bytes_per_block=64,
                         runs=1, mean_s=1e-3, best_s=1e-3, busbw_gbps=0.1,
                         verified=True)
    assert list(json.loads(rec.to_json())) == fields
    jrec = jh.BenchRecord(**dataclasses.asdict(rec))
    assert json.loads(jrec.to_json()) == json.loads(rec.to_json())


@pytest.mark.parametrize("p,msize", [(8, 16), (6, 1), (3, 1000)])
def test_pattern_matches_jax(p, msize):
    for dtype, jdt in ((torch.int32, np.int32), (torch.float32, np.float32)):
        want = jh._pattern(p, msize, jdt)
        got = th._pattern(p, msize, dtype).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("family", th.FAMILIES)
@pytest.mark.parametrize("p", [8, 6])
def test_sweep_family_verifies_every_record(family, p):
    recs = th.sweep_family(make_mesh(p, device="cpu"), family,
                           sizes=(1, 16), dtype=torch.float32, runs=2,
                           warmup=1)
    algs = list_algorithms(family)
    assert recs and all(r.verified for r in recs)
    assert {r.algorithm for r in recs} <= set(algs)
    if p == 8:
        assert {r.algorithm for r in recs} == set(algs)
    for r in recs:
        assert r.p == p and r.dtype == "float32" and r.runs == 2
        assert r.busbw_gbps >= 0 and r.best_s <= r.mean_s
    assert "busbw" in th.format_table(recs)


@pytest.mark.parametrize("family", th.FAMILIES)
def test_flipped_bit_fails_verify(family):
    run, verify = th._setup(family, make_mesh(4, device="cpu"), "p", 8,
                            torch.int32)
    out = run("xla").clone()
    assert verify(out)
    out.view(-1)[3] ^= 1 << 4
    assert not verify(out)


@pytest.mark.parametrize("seed", range(24))
def test_fuzz_port_outputs_pass_jax_oracle(seed):
    """test_fuzz_collectives' random configurations: the port's output
    passes JAX's closed-form verify and the port's own."""
    rng = np.random.default_rng(seed)
    family = th.FAMILIES[rng.integers(len(th.FAMILIES))]
    p = int(rng.choice([2, 3, 4, 5, 6, 8]))
    msize = int(rng.choice([1, 3, 8, 17, 64, 200]))
    dtype = [torch.int32, torch.float32][rng.integers(2)]
    algs = list_algorithms(family)
    algorithm = algs[rng.integers(len(algs))]
    run, verify = th._setup(family, make_mesh(p, device="cpu"), "p", msize,
                            dtype)
    try:
        out = run(algorithm)
    except UnsupportedMeshError:
        assert p & (p - 1), (
            f"{family}/{algorithm} rejected a power-of-2 mesh p={p}")
        return
    _, j_verify = jh._setup(family, j_make_mesh(p), "p", msize,
                            np.dtype(str(dtype).removeprefix("torch.")))
    assert verify(out) and j_verify(out.numpy()), (
        f"oracle mismatch: {family}/{algorithm} p={p} msize={msize} "
        f"{dtype}")


def test_checked_sweep_is_refused():
    with pytest.raises(NotImplementedError, match="A5"):
        th.sweep_family(make_mesh(4, device="cpu"), "allreduce",
                        sizes=(4,), checked=True)


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-m", "icikit_torch.bench.run",
                           *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)


def test_cli_simulated_sweep_exits_zero(tmp_path):
    out = tmp_path / "recs.jsonl"
    r = _cli("--simulate", "--family", "allreduce", "--sizes", "16",
             "--json", str(out))
    assert r.returncode == 0, r.stderr
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert {x["algorithm"] for x in recs} == set(
        list_algorithms("allreduce"))
    assert all(x["verified"] and x["p"] == 8 for x in recs)


def test_cli_refuses_checked(capsys):
    from icikit_torch.bench import run
    with pytest.raises(SystemExit) as e:
        run.main(["--simulate", "--family", "allreduce", "--sizes", "16",
                  "--checked"])
    assert e.value.code != 0 and "A5" in capsys.readouterr().err
