"""icikit_torch.bench.scaling: scale points as subprocesses of the bench
CLIs on the CPU, their records against the JAX package's record keys,
the process-split point (two gloo processes, ``--processes 2``), and the
port's records never landing in the JAX package's files."""

from __future__ import annotations

import dataclasses
import json
import os

import pytest

from icikit.bench.harness import BenchRecord as JBenchRecord
from icikit.bench.sort import SortRecord as JSortRecord
from icikit_torch.bench import scaling as S
from icikit_torch.bench.report import render_report

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    # the points' processes share the host with the other test workers
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _keys(cls) -> set:
    return {f.name for f in dataclasses.fields(cls)}


def test_sweep_on_the_cpu_gives_jax_record_keys():
    records = S.run_scaling_sweep(
        "allgather", ps=(2, 4), algorithms=["ring", "xla"], sizes=(4, 16),
        runs=2, device="cpu", timeout_s=240)
    assert len(records) == 8
    for r in records:
        assert _keys(JBenchRecord) <= set(r)
        assert r["verified"] and r["processes"] == 1
    assert {r["p"] for r in records} == {2, 4}
    text = render_report(records, title="T")
    assert "vs device count, msize=4" in text
    json.dumps(records)


def test_sort_point_on_the_cpu_gives_jax_record_keys():
    records = S.run_scaling_sweep(
        None, ps=(2,), algorithms=["sample", "quicksort"], sizes=(4096,),
        runs=1, device="cpu", timeout_s=240, bench="sort")
    assert [r["algorithm"] for r in records] == ["sample", "quicksort"]
    for r in records:
        assert _keys(JSortRecord) <= set(r)
        assert r["errors"] == 0 and r["matches_torch_sort"]
        assert r["p"] == 2 and r["processes"] == 1
    text = S._render_sort_scaling(records)
    assert "Mkeys/s vs p" in text and "quicksort" in text


@pytest.mark.parametrize("bench", ["collectives", "sort"])
def test_point_across_two_processes(bench):
    """``processes=2``: the point's 8 ranks split 4 + 4 across two gloo
    processes (the mpirun -np 2 analog); every record is verified and
    says so. Skips only when no local port can be bound."""
    from icikit_torch.utils.net import free_port
    try:
        free_port()
    except OSError as e:  # pragma: no cover - environmental
        pytest.skip(f"cannot bind a local port: {e}")
    if bench == "sort":
        records = S.run_scale_point(
            None, 8, algorithms=["bitonic", "sample", "quicksort"],
            sizes=(1 << 14,), runs=1, device="cpu", processes=2,
            timeout_s=240, bench="sort")
        assert len(records) == 3
        assert all(r["errors"] == 0 and r["matches_torch_sort"]
                   for r in records)
    else:
        records = S.run_scale_point(
            "broadcast", 8, sizes=(4, 64), runs=2, device="cpu",
            processes=2, timeout_s=240)
        assert len(records) == 6
        assert all(r["verified"] for r in records)
    assert all(r["processes"] == 2 and r["p"] == 8 for r in records)


def test_never_writes_the_jax_records(tmp_path):
    for name in ("scaling.jsonl", "sort_scaling.jsonl"):
        with pytest.raises(ValueError, match="JAX package"):
            S.main(["--json", os.path.join(ROOT, name), "--ps", "2"])
    with pytest.raises(ValueError, match="JAX package"):
        S.write_sort_scaling_md(str(tmp_path / "none.jsonl"),
                                os.path.join(ROOT, "SORTSCALING.md"))
    assert (S.DEFAULT_JSON, S.SORT_JSON, S.SORT_MD) == (
        "scaling_torch.jsonl", "sort_scaling_torch.jsonl",
        "SORTSCALING_TORCH.md")


def test_sort_scaling_document_from_records(tmp_path):
    recs = tmp_path / "s.jsonl"
    rows = [{"algorithm": a, "p": p, "n": 1 << 16, "errors": 0,
             "keys_per_s": 1e6 * p, "processes": k}
            for a in ("bitonic", "sample") for p, k in
            ((2, 1), (4, 1), (8, 1), (8, 2))]
    recs.write_text("".join(json.dumps(r) + "\n" for r in rows))
    out = tmp_path / "SORT.md"
    out.write_text("# mine\n\nkept\n")
    S.write_sort_scaling_md(str(recs), str(out))
    S.write_sort_scaling_md(str(recs), str(out))  # refreshes in place
    text = out.read_text()
    assert text.startswith("# mine\n\nkept")
    assert text.count(S._GEN_BEGIN) == 1
    assert "| 8/2 |" in text and "Analytic sort schedule counts" in text
    assert "crossover" in text
