"""The port's attention and Adam benches on the CPU: their records, their
oracles and their refusals.

The attention bench at tiny sizes verifies every subject against the
dense oracle and, with the dense budget lowered, against the chunked
plain versions (the long-context oracle), with JAX's 3e-2
magnitude-normalized tolerance; its FLOP count equals JAX's. The Adam
bench runs its three arms on a small leaf. CPU numbers are CPU numbers:
the tests check shapes and keys, never speed.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from icikit.bench.attention import AttnRecord as JAttnRecord
from icikit.bench.attention import attention_flops as j_flops
from icikit_torch.bench import adam as tadam
from icikit_torch.bench import attention as tatt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("mode", ["fwd", "fwdbwd"])
def test_attention_sweep_verifies_on_cpu(mode):
    recs = tatt.sweep_attention((64, 96), batch=1, heads=2, d_head=32,
                                dtype="float32", mode=mode, runs=1,
                                warmup=1, device="cpu", windows=1)
    assert [(r.impl, r.seq) for r in recs] == [
        (i, s) for s in (64, 96) for i in ("dense", "flash", "flash_shift")]
    for r in recs:
        assert r.verified and r.max_err < 1e-5, r
        assert r.device == "cpu" and r.launches == {}
        assert np.isfinite(r.tflops) and r.mean_s > 0
    jkeys = {f.name for f in dataclasses.fields(JAttnRecord)}
    assert jkeys <= set(json.loads(recs[0].to_json()))


def test_attention_chunked_oracle_past_the_dense_budget(monkeypatch):
    """Past the dense budget the oracle is the plain versions chunk by
    chunk: the flash subject verifies against it, forward and backward,
    in float32 and bf16."""
    monkeypatch.setattr(tatt, "_DENSE_ORACLE_MAX_SCORES", 0)
    monkeypatch.setattr(tatt, "ORACLE_CHUNK", 48)
    for dtype, mode in (("float32", "fwdbwd"), ("bfloat16", "fwdbwd"),
                        ("float32", "fwd")):
        recs = tatt.sweep_attention((128,), impls=["flash"], batch=1,
                                    heads=2, d_head=32, dtype=dtype,
                                    mode=mode, runs=1, warmup=1,
                                    device="cpu", windows=1)
        assert recs[0].verified, recs[0]
        assert recs[0].max_err < (1e-5 if dtype == "float32" else 3e-2)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("mode", ["fwd", "fwdbwd"])
def test_attention_flops_match_jax(causal, mode):
    assert tatt.attention_flops(1, 131072, 4, 128, causal, mode) == \
        j_flops(1, 131072, 4, 128, causal, mode)


def test_attention_bench_cli_and_refusals():
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-m", "icikit_torch.bench.attention",
                        "--device", "cpu", "--seqs", "64", "--impls",
                        "flash", "--batch", "1", "--heads", "2", "--dhead",
                        "32", "--runs", "1", "--warmup", "1"], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert rec["verified"] and rec["impl"] == "flash"
    with pytest.raises(NotImplementedError, match="A5"):
        tatt.sweep_attention((64,), devices=2, device="cpu")
    with pytest.raises(ValueError, match="unknown impls"):
        tatt.sweep_attention((64,), impls=["ring"], device="cpu")


def test_adam_bench_runs_its_arms_on_cpu():
    recs = tadam.run_bench(params_m=0.05, runs=1, device="cpu", windows=1)
    assert [r["metric"] for r in recs] == [
        "adam_onepass_pallas_0.05M_bfloat16",
        "adam_onepass_xla_0.05M_bfloat16",
        "adam_onepass_library_0.05M_float32"]
    assert [r["bytes_per_element"] for r in recs] == [26, 26, 28]
    for r in recs:
        assert r["device"] == "cpu" and r["ms"] > 0 and r["value"] >= 0
        assert r["elements"] == 390 * 128 and r["bound_ms"] is None


def test_decode_bench_int8_cli_on_cpu():
    """The int8 rows of the decode bench: the ``_q8`` metric, the int8
    byte model, the fused step resolved, on the CPU."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-m", "icikit_torch.bench.decode",
                        "--device", "cpu", "--preset", "tiny128", "--batch",
                        "2", "--prompt", "8", "--new", "4", "--decode-quant",
                        "int8", "--decode-step", "fused", "--runs", "1"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert rec["metric"] == "decode_tiny128_dp1tp1_b2_q8_p8_n4_greedy_fused"
    assert rec["decode_quant"] == "int8" and rec["bytes_dtype"] == "int8"
    assert rec["decode_step_resolved"] == "fused"
    assert rec["bytes_model"] == "int8-weights-and-cache-no-resident"
    assert rec["value"] > 0 and rec["device"] == "cpu"


@pytest.mark.parametrize("bytes_dtype", ["bf16", "int8"])
def test_decode_byte_model_int8_matches_jax(bytes_dtype):
    """The decode byte model at ``base`` b 8, 576 columns, no resident
    share, equals JAX's at both widths; int8 reads 301.9 MB a step."""
    from icikit.bench.decode import decode_bytes_per_token as j_bytes
    from icikit.bench.decode import quant_scale_count as j_scales
    from icikit.models.transformer import TransformerConfig as JConfig
    from icikit_torch.bench.decode import (decode_bytes_per_token,
                                           make_config, quant_scale_count)

    cfg = make_config("base", 512, 64)
    jcfg = JConfig(**{f: getattr(cfg, f) for f in (
        "vocab", "d_model", "n_heads", "d_head", "d_ff", "n_layers",
        "max_seq")})
    assert decode_bytes_per_token(cfg, 8, 576, bytes_dtype=bytes_dtype) \
        == j_bytes(jcfg, 8, 576, vmem_resident=0, bytes_dtype=bytes_dtype)
    assert quant_scale_count(cfg) == j_scales(jcfg) == 143_360
    if bytes_dtype == "int8":
        assert round(decode_bytes_per_token(cfg, 8, 576, bytes_dtype="int8")
                     / 1e5) == 3019
