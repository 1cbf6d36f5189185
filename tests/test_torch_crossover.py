"""icikit_torch.bench.crossover against icikit.bench.crossover.

The model is JAX's; only the constants differ (the port's are an H100's
and NVLink's). With JAX's three constants set on the port's module, the
port's table equals JAX's exactly and survives a JSON round trip; the
port's own defaults are not JAX's TPU values.
"""

from __future__ import annotations

import json

import pytest

from icikit.bench import crossover as J
from icikit_torch.bench import crossover as T

N = 1 << 16
PS = (2, 4, 8, 16)


@pytest.fixture
def jax_constants(monkeypatch):
    monkeypatch.setattr(T, "R_CMP", J.R_CMP)
    monkeypatch.setattr(T, "R_MERGE", J.R_MERGE)
    monkeypatch.setattr(T, "B_LINK", J.B_ICI)


@pytest.mark.parametrize("pair", [("bitonic", "quicksort"),
                                  ("sample", "sample_bitonic")])
def test_table_equals_jax_at_jax_constants(jax_constants, pair):
    inc, ch = pair
    got = T.crossover_table(N, ps=PS, incumbent=inc, challenger=ch)
    want = J.crossover_table(N, ps=PS, incumbent=inc, challenger=ch)
    assert got == want
    assert json.loads(json.dumps(got)) == got
    for a_us in (1.0, 25.0):
        assert T.predict_time(inc, 8, N, a_us * 1e-6) == \
            J.predict_time(inc, 8, N, a_us * 1e-6)


def test_defaults_are_not_the_tpu_values():
    assert T.R_CMP != J.R_CMP
    assert T.R_MERGE != J.R_MERGE
    assert T.B_LINK != J.B_ICI
    # NVLink 4 on the H100 SXM: 450 GB/s a direction, derated 10%
    assert T.B_LINK == pytest.approx(0.9 * 450e9)
    md = T.render_markdown(T.crossover_table(N, ps=PS))
    assert "v5e" not in md and "ICI" not in md
    assert "specification" in md


def test_comparator_rate_and_merge_rate_on_the_cpu():
    """R_CMP is read off a sort as n log2 n comparisons a second; the
    merge microbench runs on the CPU when asked and names the device."""
    assert T.comparator_rate(1 << 28, 0.0282) == pytest.approx(
        (1 << 28) * 28 / 0.0282)
    rec = T.measure_merge_rate(n=1 << 12, device="cpu")
    assert rec["r_merge_bench_backend"] == "cpu"
    assert rec["r_merge_measured_keys_per_s"] > 0
    assert rec["r_merge_bench_n"] == 1 << 12


def test_cli_refuses_the_jax_records(tmp_path):
    with pytest.raises(ValueError, match="JAX package"):
        T.main(["--n", "4096", "--json", J.__file__.replace(
            "icikit/bench/crossover.py", "crossover.jsonl")])
    out = tmp_path / "c.jsonl"
    assert T.main(["--n", "4096", "--json", str(out)]) == 0
    tab = json.loads(out.read_text())
    assert tab["algs"] == ["bitonic", "quicksort"]
