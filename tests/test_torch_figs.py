"""icikit_torch.bench.figs against icikit.bench.figs: from the same
records the port renders the same figures (by name) as JAX, skips
missing records as JAX does, filters timing artifacts above its ceiling
as JAX filters above its own, and never writes into JAX's figure
directory."""

from __future__ import annotations

import json
import os

import pytest

from icikit.bench import figs as J
from icikit_torch.bench import figs as T


def _write(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def _records(tmp_path) -> dict:
    sc, ns, lc, ss = (tmp_path / f"{n}.jsonl" for n in
                      ("scaling", "northstar", "longcontext", "sort"))
    _write(sc, [{"family": "allgather", "algorithm": a, "p": p,
                 "msize": m, "best_s": 1e-4 * m * p / 64}
                for a in ("ring", "xla") for p in (2, 8)
                for m in (1, 65536)]
           + [{"family": "alltoall", "algorithm": "hypercube", "p": 8,
               "msize": 16, "best_s": 1e-4},
              {"family": "allreduce", "algorithm": "ring", "p": 4,
               "msize": 65536, "best_s": 2e-3}])
    _write(ns, [{"kind": "sort", "algorithm": a, "p": 1, "n": 1 << 20,
                 "distribution": "uniform", "keys_per_s": k}
                for a, k in (("bitonic", 1e8), ("sample", 5e7))])
    _write(lc, [{"impl": "flash", "mode": "fwd", "seq": 32768,
                 "d_head": 64, "tflops": 66.0, "verified": True},
                {"impl": "flash", "mode": "fwdbwd", "seq": 32768,
                 "d_head": 128, "tflops": 170.0, "verified": True}])
    _write(ss, [{"algorithm": a, "p": p, "n": n, "distribution": "uniform",
                 "errors": 0, "keys_per_s": 1e6 * p}
                for a in ("bitonic", "quicksort") for p in (2, 4, 8)
                for n in (1 << 16, 1 << 20)])
    return dict(scaling=str(sc), northstar=str(ns), longcontext=str(lc),
                sort_scaling=str(ss))


def test_same_figures_as_jax(tmp_path):
    import matplotlib
    matplotlib.use("Agg")
    recs = _records(tmp_path)
    got = T.render_all(outdir=str(tmp_path / "torch"), **recs)
    want = J.render_all(outdir=str(tmp_path / "jax"), **recs)
    assert sorted(map(os.path.basename, got)) == \
        sorted(map(os.path.basename, want))
    assert len(got) == 7
    for p in got:
        assert os.path.getsize(p) > 10_000  # real rendered images


def test_missing_records_are_skipped(tmp_path):
    import matplotlib
    matplotlib.use("Agg")
    none = str(tmp_path / "none.jsonl")
    kw = dict(scaling=none, northstar=none, longcontext=none,
              sort_scaling=none)
    assert T.render_all(outdir=str(tmp_path / "t"), **kw) == []
    assert J.render_all(outdir=str(tmp_path / "j"), **kw) == []


def test_artifact_filter_acts_as_jax(tmp_path):
    """A reading above the ceiling never enters a curve: a figure from
    such readings alone is not drawn, one with a reading below is. The
    port's ceiling is the H100's published bf16 peak, JAX's its TPU's
    measured one."""
    import matplotlib
    matplotlib.use("Agg")
    for mod in (T, J):
        above = {"impl": "flash", "mode": "fwd", "seq": 16384,
                 "d_head": 128, "tflops": mod._TFLOPS_CEILING + 1.0,
                 "verified": True}
        below = dict(above, tflops=mod._TFLOPS_CEILING / 4)
        assert mod.fig_longcontext([above], str(tmp_path)) is None
        path = mod.fig_longcontext([above, below], str(tmp_path))
        assert path and os.path.getsize(path) > 10_000
    assert T._TFLOPS_CEILING == 989.0


def test_never_writes_into_jax_figures(tmp_path):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with pytest.raises(ValueError, match="JAX package"):
        T.render_all(outdir=os.path.join(root, "docs", "figs"),
                     scaling=str(tmp_path / "none.jsonl"))
