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


def test_flash_bwd_ab_refuses_without_a_card(monkeypatch):
    """The flash A/B bench (its backward kernels here) times kernels on
    the card only: without one it exits before building anything."""
    import torch

    from icikit_torch.bench import flash_ab

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        flash_ab.main(["--a", "a.cu", "--b", "b.cu", "--kernels", "bwd"])


def test_flash_ab_forward_shapes_and_bounds():
    """The forward's A/B shapes are the paths' (online at the prefill
    and at 131072, shift 16 at the train step's and the many-block
    shape), with the bounds that PERF.md carries for them: bytes at the
    prefill and the train step, the two causal products at the others;
    an unknown shape or kernel is refused before anything builds."""
    from icikit_torch.bench import flash_ab

    assert flash_ab.FWD_SHAPES == {
        "B3": ((8, 8, 512, 128), None),
        "B5-shift": ((8, 8, 1024, 128), 16.0),
        "B4": ((1, 8, 2048, 128), 16.0),
        "long": ((1, 4, 131072, 128), None)}
    want = {"B3": (0.01006, "bytes"), "B5-shift": (0.02011, "bytes"),
            "B4": (0.00869, "operations"), "long": (17.788, "operations")}
    for tag, (ms, by) in want.items():
        got_ms, got_by = flash_ab.bound_ms("fwd", flash_ab.FWD_SHAPES[tag][0])
        assert got_by == by and got_ms == pytest.approx(ms, rel=1e-3), tag
    # the backward's B8 bound: the five causal products, 44.47 ms
    ms, by = flash_ab.bound_ms("bwd", flash_ab.BWD_SHAPES["B8"])
    assert by == "operations" and ms == pytest.approx(44.47, rel=1e-3)
    for argv in (["--kernels", "fwd,xyz"], ["--fwd-shapes", "B9"]):
        with pytest.raises(SystemExit):
            flash_ab.main(["--a", "a.cu", "--b", "b.cu", *argv])


def test_flash_ab_holds_b_to_a(monkeypatch):
    """B's outputs are held to A's block by block: a late block whose
    entries are small and wrong fails the block relative L2 though its
    error is small beside the largest entry; a run whose outputs departed
    exits 1 unless --timing-only."""
    import torch

    from icikit_torch.bench import flash_ab

    gen = torch.Generator().manual_seed(0)
    a = torch.randn((1, 2, 256, 32), generator=gen)
    a[:, :, 128:] *= 1e-3
    b = a.clone()
    b[:, :, 192:] = -b[:, :, 192:]
    assert flash_ab._rel(b, a) < flash_ab.TOL["block_rel_l2"]
    assert flash_ab.block_rel_l2(b, a) == pytest.approx(2.0)
    assert flash_ab.block_rel_l2(a, a) == 0.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for ok in (True, False):
        monkeypatch.setattr(flash_ab, "run", lambda *args, ok=ok: ok)
        argv = ["--a", "a.cu", "--b", "b.cu"]
        assert flash_ab.main(argv) == (0 if ok else 1)
        assert flash_ab.main([*argv, "--timing-only"]) == 0


def test_stream_ab_refuses_without_a_card_or_sources(monkeypatch):
    """The Adam and save-stack A/B bench times kernels on the card only:
    without one it exits before building anything, and a directory
    without both sources is refused first."""
    import torch

    from icikit_torch.bench import stream_ab

    csrc = os.path.join(ROOT, "icikit_torch", "csrc")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        stream_ab.main(["--a", csrc, "--b", csrc])
    with pytest.raises(SystemExit):
        stream_ab.main(["--a", csrc, "--b", os.path.join(ROOT, "tests")])


def test_stream_ab_bytes_bounds_and_verdict(monkeypatch):
    """Adam's bytes (p, m and v read and written, g read: 26 B an
    element at bf16 gradients, 28 at float32, float32 moments), the
    16 MiB slice copy's bound (10.0 us), and the verdict: a run whose B
    departed from A exits 1 unless --timing-only."""
    import torch

    from icikit_torch.bench import stream_ab

    p = torch.zeros(10)
    assert stream_ab.adam_bytes([p], [p.bfloat16()]) == 260
    assert stream_ab.adam_bytes([p, p], [p, p.half()]) == 280 + 260
    assert stream_ab.bound_ms(2 * 16 * 2 ** 20) == pytest.approx(0.010016,
                                                                 rel=1e-4)
    csrc = os.path.join(ROOT, "icikit_torch", "csrc")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for ok in (True, False):
        monkeypatch.setattr(stream_ab, "run", lambda *args, ok=ok: ok)
        argv = ["--a", csrc, "--b", csrc]
        assert stream_ab.main(argv) == (0 if ok else 1)
        assert stream_ab.main([*argv, "--timing-only"]) == 0


def test_build_keys_libraries_by_source_and_flags(tmp_path):
    """A library is named by a hash of its source and its nvcc flags, in
    the directory asked for: another source, or the same source with
    other flags, builds anew; the package's own sources keep the key
    they had (the flags alone)."""
    from icikit_torch.ops import _build

    src = tmp_path / "a.cu"
    src.write_text("// one\n")
    out = str(tmp_path / "ab")
    _, plain = _build._target("attention", str(src), out)
    _, verbose = _build._target("attention", str(src), out,
                                ("-Xptxas", "-v"))
    assert os.path.dirname(plain) == out and plain != verbose
    assert os.path.basename(plain).startswith("libattention-")
    src.write_text("// two\n")
    assert _build._target("attention", str(src), out)[1] != plain
    own_src, own = _build._target("attention")
    assert own_src == os.path.join(_build.CSRC, "attention.cu")
    assert os.path.dirname(own) == _build.BUILD_DIR


def test_build_sources_builds_a_library_once(monkeypatch, tmp_path):
    """Two keys naming the same source and flags share one build (one
    nvcc, one temporary file), and each key gets the library."""
    from icikit_torch.ops import _build

    src = tmp_path / "a.cu"
    src.write_text("// one\n")
    other = tmp_path / "b.cu"
    other.write_text("// two\n")
    calls = []

    def start(name, s, out_dir, flags):
        calls.append(s)
        return s, None, None, None

    monkeypatch.setattr(_build, "_start", start)
    monkeypatch.setattr(_build, "_finish",
                        lambda name, so, *a, optional: (so, "log", None))
    got = _build.build_sources("attention", {"A": str(src), "B": str(src),
                                             "C": str(other)},
                               str(tmp_path / "ab"), ["-Xptxas", "-v"])
    assert calls == [str(src), str(other)]
    assert got == {"A": (str(src), "log"), "B": (str(src), "log"),
                   "C": (str(other), "log")}
