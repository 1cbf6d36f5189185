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
    # the sequence-parallel rows: JAX's impls on a rank mesh, each held
    # to the dense oracle
    recs = tatt.sweep_attention((64,), impls=["ring", "zigzag", "ulysses"],
                                batch=1, heads=2, d_head=32, runs=1,
                                warmup=1, devices=2, device="cpu",
                                windows=1)
    assert [r.impl for r in recs] == ["ring", "zigzag", "ulysses"]
    assert all(r.verified and r.p == 2 for r in recs)
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


def test_sort_ab_refuses_without_a_card_or_sources(monkeypatch):
    """The sort A/B bench times the kernels on the card only: without
    one it exits before building anything; a directory without
    ``bitonic_net.cu`` and a malformed geometry are refused first."""
    import torch

    from icikit_torch.bench import sort_ab

    csrc = os.path.join(ROOT, "icikit_torch", "csrc")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        sort_ab.main(["--a", csrc, "--b", csrc])
    with pytest.raises(SystemExit):
        sort_ab.main(["--a", csrc, "--b", os.path.join(ROOT, "tests")])
    with pytest.raises(SystemExit):
        sort_ab.main(["--a", csrc, "--b", csrc, "--geom-b", "14,14,10,odd"])


def _reference_plan(n, tile, g_max):
    """The reference's ``_build_sort`` grouping (pallas_sort.py:304-347)
    at t_big = tile: each round's cross passes filled to g_max bits from
    the top."""
    from icikit_torch.ops import cuda_sort as cs

    log2t = cs.ilog2(tile)
    plan = [("net", tile, cs._sort_rounds(log2t))]
    for i in range(log2t, cs.ilog2(n)):
        hi = i - log2t
        while hi >= 0:
            lo = max(0, hi - g_max + 1)
            plan.append(("cross", 1 << (i + 1), tile, lo, hi, False))
            hi = lo - 1
        plan.append(("net", tile, [(i + 1, tuple(
            1 << j for j in range(log2t - 1, -1, -1)))]))
    return plan


def test_sort_ab_kinds_bounds_and_verdict(monkeypatch):
    """A 2^28 schedule split by kind (the in-tile sort, the other K1
    launches, K2) with its stages; the byte bound (0.641 ms a launch)
    and the in-tile sort's int32 issue time (1.69 ms for the 105 stages
    of a 2^14 tile); the parent's K2 block width for a source without
    ``icikit_cross_log2cb``; the verdict: a departure exits 1 unless
    --timing-only."""
    import torch

    from icikit_torch.bench import sort_ab
    from icikit_torch.ops import cuda_sort as cs

    n = 1 << 28
    plan = cs.sort_schedule(n, 1 << 14, 1 << 14, 10)
    kinds = sort_ab.by_kind(plan, [1.0] * len(plan), n)
    assert {k: v["launches"] for k, v in kinds.items()} == {
        "net_sort": 1, "net_round": 14, "cross": 18}
    assert kinds["net_sort"]["stages"] == 105
    assert kinds["cross"]["stages"] == sum(range(1, 15))
    assert kinds["cross"]["ms"] == 18.0
    assert sort_ab.bytes_ms(n) == pytest.approx(0.641, abs=1e-3)
    assert sort_ab.int32_issue_ms(n, 105) == pytest.approx(1.685, abs=1e-3)
    assert sort_ab._geom("13,13,9,greedy") == (13, 13, 9, "greedy")
    # the reference's grouping: 11 bits at g_max 10 as 10 + 1, not 6 + 5
    assert [(s[3], s[4]) for s in sort_ab.greedy(plan, 10)
            if s[0] == "cross" and s[1] == 1 << 25] == [(1, 10), (0, 0)]
    assert [(s[3], s[4]) for s in plan
            if s[0] == "cross" and s[1] == 1 << 25] == [(5, 10), (0, 4)]
    assert sort_ab.greedy(cs.sort_schedule(n, 1 << 13, 1 << 13, 9), 9) == \
        _reference_plan(n, 1 << 13, 9)
    assert sort_ab._geom("14,14,10") == (14, 14, 10, "even")

    class Parent:     # a library without icikit_cross_log2cb
        pass

    assert [sort_ab.log2cb(Parent(), 1 << 13, g) for g in (1, 5, 9)] == [
        13, 9, 5]
    csrc = os.path.join(ROOT, "icikit_torch", "csrc")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for ok in (True, False):
        monkeypatch.setattr(sort_ab, "run", lambda *args, ok=ok: ok)
        argv = ["--a", csrc, "--b", csrc]
        assert sort_ab.main(argv) == (0 if ok else 1)
        assert sort_ab.main([*argv, "--timing-only"]) == 0


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


def test_build_hashes_the_headers_beside_a_source(tmp_path):
    """An edit to a header beside a source (the shared ``hopper.cuh``)
    renames the library, so a stale build is never loaded; a header
    elsewhere does not; the package's own sources hash theirs."""
    from icikit_torch.ops import _build

    src = tmp_path / "xent.cu"
    src.write_text('#include "hopper.cuh"\n')
    head = tmp_path / "hopper.cuh"
    head.write_text("// one\n")
    out = str(tmp_path / "ab")
    _, first = _build._target("xent", str(src), out)
    head.write_text("// two\n")
    _, second = _build._target("xent", str(src), out)
    assert first != second
    (tmp_path / "ab").mkdir()
    (tmp_path / "ab" / "other.cuh").write_text("// three\n")
    assert _build._target("xent", str(src), out)[1] == second
    assert os.path.isfile(os.path.join(_build.CSRC, "hopper.cuh"))


def test_xent_ab_refuses_without_a_card_or_sources(monkeypatch):
    """The recompute head's A/B bench times kernels on the card only:
    without one it exits before building anything, and a directory
    without ``xent.cu`` is refused first."""
    import torch

    from icikit_torch.bench import xent_ab

    csrc = os.path.join(ROOT, "icikit_torch", "csrc")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        xent_ab.main(["--a", csrc, "--b", csrc])
    with pytest.raises(SystemExit):
        xent_ab.main(["--a", csrc, "--b", os.path.join(ROOT, "tests")])


def test_xent_ab_shape_bounds_and_verdict(monkeypatch):
    """The A/B shape is the base step's head (T 8192, D 1024, V 32768);
    the bound of dx and of dw is the rebuild and the contraction, 2 x 2 T
    V D operations, 1.112 ms at 989 TFLOP/s (their bytes, ~88 MB, take
    0.026 ms); a run whose B departed exits 1 unless --timing-only."""
    import torch

    from icikit_torch.bench import xent_ab

    assert xent_ab.SHAPE == (8192, 1024, 32768)
    assert xent_ab.TOL == 2e-2
    for which in ("dx", "dw"):
        ms, by = xent_ab.bound_ms(which, *(8192, 1024, 32768))
        assert by == "operations" and ms == pytest.approx(1.1117, rel=1e-3)
    ms, by = xent_ab.bound_ms("dx", 8, 4096, 16)
    assert by == "bytes"
    csrc = os.path.join(ROOT, "icikit_torch", "csrc")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for ok in (True, False):
        seen = []
        monkeypatch.setattr(xent_ab, "run",
                            lambda *a, ok=ok: seen.append(a) or ok)
        argv = ["--a", csrc, "--b", csrc]
        assert xent_ab.main(argv) == (0 if ok else 1)
        assert xent_ab.main([*argv, "--timing-only"]) == 0
        assert seen == [(csrc, csrc)] * 2


def test_tile_floor_ab_refuses_without_a_card_or_sources(monkeypatch):
    """The tile-floor A/B bench times kernels on the card only: without
    one it exits before building anything, and a directory without
    ``tile_floor.cu`` or a missing arm is refused first."""
    import torch

    from icikit_torch.bench import tile_floor_ab

    csrc = os.path.join(ROOT, "icikit_torch", "csrc")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        tile_floor_ab.main(["--a", csrc, "--b", csrc])
    for argv in (["--a", csrc, "--b", os.path.join(ROOT, "tests")],
                 ["--a", csrc]):
        with pytest.raises(SystemExit):
            tile_floor_ab.main(argv)


def test_tile_floor_ab_shapes_bounds_and_verdict(monkeypatch):
    """The A/B shapes are the tile-floor path's, (1, 8, 32768) at d 64
    and 128; a variant's bound is its operations over the rectangle, 4 *
    128 * 128 * d a tile, 2.22 ms at d 64 and 4.45 at d 128 (q, k, v and
    out take 0.04 ms), counted in the kernels' 128 x 128 tiles; the two
    arms are source directories, softmax_ks1 meets SDPA in ten pairs, and
    a run whose outputs departed exits 1 unless --timing-only."""
    import torch

    from icikit_torch.bench import tile_floor_ab
    from icikit_torch.bench.tile_floor import ABLATIONS
    from icikit_torch.ops import cuda_tile_floor as ctf

    assert tile_floor_ab.SHAPE == (1, 8, 32768)
    assert tile_floor_ab.DIMS == ctf.HEAD_DIMS == (64, 128)
    assert tile_floor_ab.TOL == 2e-2
    assert tile_floor_ab.VARIANTS[1:] == ABLATIONS
    assert tile_floor_ab.LOG2E_JAX == 1.442695
    assert ctf.TILE == 128 and tile_floor_ab.PAIRS == 10
    for d, want in ((64, 2.22348), (128, 4.44696)):
        ms, by = tile_floor_ab.bound_ms(*tile_floor_ab.SHAPE, d)
        assert by == "operations" and ms == pytest.approx(want, rel=1e-4)
    assert tile_floor_ab.bound_ms(1, 1, 128, 64)[1] == "bytes"
    csrc = os.path.join(ROOT, "icikit_torch", "csrc")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for ok in (True, False):
        seen = []
        monkeypatch.setattr(tile_floor_ab, "run",
                            lambda *a, ok=ok: seen.append(a) or ok)
        argv = ["--a", csrc, "--b", csrc]
        assert tile_floor_ab.main(argv) == (0 if ok else 1)
        assert tile_floor_ab.main([*argv, "--timing-only"]) == 0
        assert seen == [({"A": csrc, "B": csrc},)] * 2


def test_flash_ab_decode_q8_shapes_and_bounds():
    """``--kernels decode_q8`` times the int8 step at the int8 path's
    64 rows, 576 columns, cur 543, dh 128 and 256, against the bound of
    its bytes (2.78 us at dh 128: 8.9 MB of int8 K and V, 0.28 MB of
    scales); its products at the float32 rate take less."""
    from icikit_torch.bench import flash_ab

    assert "decode_q8" in flash_ab.KERNELS
    assert flash_ab.Q8_SHAPES == {"dh128": (64, 576, 128, 543),
                                  "dh256": (64, 576, 256, 543)}
    assert flash_ab.Q8_TOL == 1e-5
    for tag, want in (("dh128", 0.0027827), ("dh256", 0.0054824)):
        ms, by = flash_ab.q8_bound_ms(*flash_ab.Q8_SHAPES[tag])
        assert by == "bytes" and ms == pytest.approx(want, rel=1e-4), tag
    with pytest.raises(SystemExit):
        flash_ab.main(["--a", "a.cu", "--b", "b.cu", "--kernels",
                       "decode_q8,xyz"])


def test_flash_ab_decode_shapes_and_bounds():
    """``--kernels decode`` times the bf16 step (B13) at the bf16 path's
    64 rows, 576 columns, cur 543, dh 128 and 256, against the bound of
    its bytes (5.34 us at dh 128: 17.8 MB of bf16 K and V); its products
    at the float32 rate take less. The caches rotate through enough
    copies to pass 256 MiB, past the card's 50 MB L2."""
    from icikit_torch.bench import flash_ab

    assert "decode" in flash_ab.KERNELS and "decode_q8" in flash_ab.KERNELS
    assert flash_ab.DECODE_TOL == 2e-2
    for tag, want in (("dh128", 0.005341), ("dh256", 0.010682)):
        ms, by = flash_ab.decode_bound_ms(*flash_ab.Q8_SHAPES[tag])
        assert by == "bytes" and ms == pytest.approx(want, rel=1e-4), tag
    # float32 caches read twice the bytes
    assert flash_ab.decode_bound_ms(64, 576, 128, 543, 4)[0] == \
        pytest.approx(2 * 0.005341, rel=1e-3)
    from icikit_torch.bench.stream_ab import ROTATE_BYTES, copies_past_l2

    nbytes = 4 * 64 * 576 * 128
    assert ROTATE_BYTES == 256 << 20
    assert copies_past_l2(nbytes) == 15
    assert copies_past_l2(nbytes) * nbytes >= ROTATE_BYTES
    assert copies_past_l2(1 << 30) == 2
    with pytest.raises(SystemExit):
        flash_ab.main(["--a", "a.cu", "--b", "b.cu", "--kernels",
                       "decode,xyz"])


def test_quant_ab_refuses_without_a_card_or_sources(monkeypatch):
    """The skinny matvec's A/B bench times kernels on the card only:
    without one it exits before building anything; a missing source or
    an unknown shape is refused first."""
    import torch

    from icikit_torch.bench import quant_ab

    src = os.path.join(ROOT, "icikit_torch", "csrc", "quant.cu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        quant_ab.main(["--a", src, "--b", src])
    for argv in (["--a", src, "--b", src + ".missing"],
                 ["--a", src, "--b", src, "--shapes", "wqkv,w3"]):
        with pytest.raises(SystemExit):
            quant_ab.main(argv)


def test_quant_ab_shapes_bounds_and_verdict(monkeypatch):
    """The A/B shapes are the int8 path's five products at rows 8 (12
    layers of wqkv, wo, w1, w2 and one w_out a step), each bound by its
    bytes (wqkv 0.98 us, w_out 10.4 us; 0.057 ms a step); the split
    sweep takes only what the entry accepts (a CTA holds 64 chunks of K
    at rows 8, 32 at rows 16); the weights rotate past
    256 MiB; a run whose outputs departed exits 1 unless --timing-only."""
    import torch

    from icikit_torch.bench import quant_ab

    assert quant_ab.SHAPES == {"wqkv": (3072, 1024), "wo": (1024, 1024),
                               "w1": (4096, 1024), "w2": (1024, 4096),
                               "w_out": (32768, 1024)}
    assert quant_ab.ROWS == 8 and quant_ab.TOL == 1e-4
    assert sum(quant_ab.PER_STEP.values()) == 4 * 12 + 1
    want = {"wqkv": 0.000977, "wo": 0.000329, "w1": 0.001301,
            "w2": 0.001283, "w_out": 0.010373}
    for tag, ms in want.items():
        got, by = quant_ab.bound_ms(*quant_ab.SHAPES[tag])
        assert by == "bytes" and got == pytest.approx(ms, rel=1e-3), tag
    assert quant_ab.step_ms({s: quant_ab.bound_ms(*quant_ab.SHAPES[s])[0]
                             for s in quant_ab.SHAPES}) == \
        pytest.approx(0.05705, rel=1e-3)
    assert [s for s in quant_ab.SPLIT_SWEEP
            if quant_ab.valid_splits(4096, s)] == [1, 2, 4, 8, 16]
    assert [s for s in quant_ab.SPLIT_SWEEP
            if quant_ab.valid_splits(4096, s, 16)] == [2, 4, 8, 16]
    assert not quant_ab.valid_splits(128, 4)
    from icikit_torch.bench.stream_ab import copies_past_l2, rotating

    assert copies_past_l2(1024 * 1024) == 256
    assert copies_past_l2(32768 * 1024) * 32768 * 1024 >= 256 << 20
    seen = []
    step = rotating(seen.append, "abc")
    for _ in range(4):
        step()
    assert seen == ["a", "b", "c", "a"]
    src = os.path.join(ROOT, "icikit_torch", "csrc", "quant.cu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for ok in (True, False):
        seen = []
        monkeypatch.setattr(quant_ab, "run",
                            lambda *a, ok=ok: seen.append(a) or ok)
        argv = ["--a", src, "--b", src]
        assert quant_ab.main(argv) == (0 if ok else 1)
        assert quant_ab.main([*argv, "--timing-only"]) == 0
        assert seen == [(src, src, tuple(quant_ab.SHAPES))] * 2


def test_quant_ab_prefill_shapes_and_bounds(monkeypatch):
    """``--rows 4096`` times the prefill's tile kernel at the four
    products a layer (wqkv, wo, w1, w2; 48 launches a generate), each
    bound by its products at 4096 rows (wqkv 26.1 us, wo 8.7, w1 and w2
    34.7; 0.104 ms a layer), not by its bytes; the rows and the shapes
    are checked before a card is asked for, and the run goes to the
    prefill's run with the prefill's shapes."""
    import torch

    from icikit_torch.bench import quant_ab

    assert quant_ab.PREFILL_ROWS == 4096
    assert quant_ab.PREFILL_SHAPES == ("wqkv", "wo", "w1", "w2")
    assert quant_ab.LAYERS * len(quant_ab.PREFILL_SHAPES) == 48
    want = {"wqkv": 0.026056, "wo": 0.0086855, "w1": 0.034742,
            "w2": 0.034742}
    for tag, ms in want.items():
        got, by = quant_ab.bound_ms(*quant_ab.SHAPES[tag], 4096)
        assert by == "operations" and got == pytest.approx(ms, rel=1e-3), tag
    assert quant_ab.layer_ms(
        {s: quant_ab.bound_ms(*quant_ab.SHAPES[s], 4096)[0]
         for s in quant_ab.PREFILL_SHAPES}) == pytest.approx(0.10423,
                                                            rel=1e-3)
    src = os.path.join(ROOT, "icikit_torch", "csrc", "quant.cu")
    for argv in (["--rows", "300"], ["--rows", "4096", "--shapes", "w_out"],
                 ["--rows", "4096", "--shapes", "w1,w3"]):
        with pytest.raises(SystemExit):
            quant_ab.main(["--a", src, "--b", src, *argv])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        quant_ab.main(["--a", src, "--b", src, "--rows", "4096"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    seen = []
    monkeypatch.setattr(quant_ab, "run_prefill",
                        lambda *a: seen.append(a) or False)
    monkeypatch.setattr(quant_ab, "run", lambda *a: pytest.fail("skinny"))
    argv = ["--a", src, "--b", src, "--rows", "4096"]
    assert quant_ab.main(argv) == 1
    assert quant_ab.main([*argv, "--shapes", "w1", "--timing-only"]) == 0
    assert seen == [(src, src, quant_ab.PREFILL_SHAPES), (src, src, ("w1",))]


def test_xent_ab_saved_bound_and_dispatch(monkeypatch):
    """``--flavour saved`` times the saved head's dx and dw: their bound
    is the contraction, 2 T V D operations, 0.556 ms at the base head at
    989 TFLOP/s (e, mrun, the operand and the output, ~630 MB, take 0.19
    ms); an unknown flavour is refused, no card exits before a build,
    and the run goes to the saved flavour's function."""
    import torch

    from icikit_torch.bench import xent_ab

    assert xent_ab.FLAVOURS == ("recompute", "saved", "fwd", "g", "wide")
    for which in ("dx", "dw"):
        ms, by = xent_ab.saved_bound_ms(which, 8192, 1024, 32768)
        assert by == "operations" and ms == pytest.approx(0.55587, rel=1e-4)
    ms, by = xent_ab.saved_bound_ms("dw", 8, 4096, 16)
    assert by == "bytes"
    csrc = os.path.join(ROOT, "icikit_torch", "csrc")
    with pytest.raises(SystemExit):
        xent_ab.main(["--a", csrc, "--b", csrc, "--flavour", "both"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        xent_ab.main(["--a", csrc, "--b", csrc, "--flavour", "saved"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    seen = []
    monkeypatch.setattr(xent_ab, "run_saved",
                        lambda *a: seen.append(a) or True)
    monkeypatch.setattr(xent_ab, "run", lambda *a: pytest.fail("recompute"))
    assert xent_ab.main(["--a", csrc, "--b", csrc, "--flavour",
                         "saved"]) == 0
    assert seen == [(csrc, csrc)]


def test_xent_ab_fwd_and_g_bounds():
    """``--flavour fwd`` and ``--flavour g`` time B9 and B11: at the base
    head both are bound by the logits' 2 T V D operations, 0.556 ms at
    989 TFLOP/s (the forward with save moves ~630 MB, g ~570 MB, 0.19 and
    0.17 ms); at a narrow vocabulary the bytes bound them, and save adds
    e and mrun to the forward's bytes."""
    from icikit_torch.bench import xent_ab

    assert xent_ab.LSE_TOL == 1e-3 and xent_ab.CHUNK == 128
    for save in (True, False):
        ms, by = xent_ab.fwd_bound_ms(save, 8192, 1024, 32768)
        assert by == "operations" and ms == pytest.approx(0.55587, rel=1e-4)
    ms, by = xent_ab.g_bound_ms(8192, 1024, 32768)
    assert by == "operations" and ms == pytest.approx(0.55587, rel=1e-4)
    on, by_on = xent_ab.fwd_bound_ms(True, 8, 4096, 16)
    off, by_off = xent_ab.fwd_bound_ms(False, 8, 4096, 16)
    assert by_on == by_off == "bytes"
    assert (on - off) * 1e-3 * xent_ab.MEM_BPS == pytest.approx(
        8 * 16 * 2 + 8 * 4)
    ms, by = xent_ab.g_bound_ms(8, 4096, 16)
    assert by == "bytes" and ms * 1e-3 * xent_ab.MEM_BPS == pytest.approx(
        (8 * 4096 + 16 * 4096 + 8 * 16) * 2 + 3 * 8 * 4)


@pytest.mark.parametrize("flavour,fn", [("fwd", "run_fwd"), ("g", "run_g"),
                                        ("wide", "run_wide")])
def test_xent_ab_fwd_and_g_dispatch(monkeypatch, flavour, fn):
    """No card exits before a build; with one, ``--flavour fwd``,
    ``--flavour g`` and ``--flavour wide`` go to their own functions,
    whose verdict sets the exit code unless ``--timing-only``."""
    import torch

    from icikit_torch.bench import xent_ab

    csrc = os.path.join(ROOT, "icikit_torch", "csrc")
    argv = ["--a", csrc, "--b", csrc, "--flavour", flavour]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        xent_ab.main(argv)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    seen = []
    for other in ("run", "run_saved", "run_fwd", "run_g", "run_wide"):
        if other != fn:
            monkeypatch.setattr(xent_ab, other,
                                lambda *a, o=other: pytest.fail(o))
    monkeypatch.setattr(xent_ab, fn, lambda *a: seen.append(a) or False)
    assert xent_ab.main(argv) == 1
    assert xent_ab.main([*argv, "--timing-only"]) == 0
    assert seen == [(csrc, csrc)] * 2


def test_xent_ab_wide_shape_bound_and_fallback(monkeypatch):
    """``--flavour wide`` times the recompute head past one cluster's D
    2048 at T 8192, D 4096, V 32768: dx's and dw's bound is the rebuild
    and the contraction, 2 x 2 T V D operations, 4.447 ms at 989 TFLOP/s
    (x, w and the output, ~400 MB, take 0.12 ms). A library without the
    chunk walk's entries (a source before the walk) is timed through its
    own ``icikit_xent_recompute``, once a call."""
    import torch

    from icikit_torch.bench import xent_ab

    assert xent_ab.WIDE_SHAPE == (8192, 4096, 32768)
    for which in ("dx", "dw"):
        ms, by = xent_ab.bound_ms(which, *xent_ab.WIDE_SHAPE)
        assert by == "operations" and ms == pytest.approx(4.44696, rel=1e-4)
    calls = []

    class OldLib:
        def icikit_xent_recompute(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 7})())
    x, w, out = torch.zeros((16, 8)), torch.zeros((24, 8)), torch.zeros(
        (16, 8))
    tg, lse, dn = torch.zeros(16).int(), torch.zeros(16), torch.zeros(16)
    fn = xent_ab.walk_call(OldLib(), "dx", x, w, tg, lse, dn, out)
    assert not calls
    fn()
    assert len(calls) == 1 and calls[0][:2] == (1, 1)
    assert calls[0][-4:] == (16, 24, 8, 7)


def test_solitaire_ab_refuses_without_a_card_or_sources(monkeypatch):
    """The DFS kernel's A/B bench runs on the card only: without one it
    exits before building anything; a directory without
    ``solitaire.cu`` is refused first."""
    import torch

    from icikit_torch.bench import solitaire_ab

    csrc = os.path.join(ROOT, "icikit_torch", "csrc")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        solitaire_ab.main(["--a", csrc, "--b", csrc])
    with pytest.raises(SystemExit):
        solitaire_ab.main(["--a", csrc, "--b", os.path.join(ROOT, "tests")])


def test_solitaire_ab_reads_ptxas_and_holds_b_to_a(monkeypatch):
    """ptxas's registers, spills and shared bytes are read a kernel by
    the benches' shared parser; the exit code follows B's outputs
    against A's unless ``--timing-only``."""
    from icikit_torch.bench import solitaire_ab
    from icikit_torch.bench.flash_ab import _ptxas_regs

    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z16solve_dfs_kernel' for 'sm_90a'
ptxas info    : Function properties for _Z16solve_dfs_kernel
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 87 registers, used 1 barriers, 32004 bytes smem
ptxas info    : Compiling entry function '_Z5otherv' for 'sm_90a'
ptxas info    : Used 12 registers, 0 bytes smem"""
    assert _ptxas_regs(log, lambda k: True, shared=True) == {
        "solve_dfs_kernel": (87, 8, 32004), "other": (12, None, 0)}
    assert _ptxas_regs(log, lambda k: "solve_dfs" in k) == {
        "solve_dfs_kernel": (87, 8)}
    assert [n for n, _ in solitaire_ab.FULL] == ["easy", "medium", "hard"]
    assert solitaire_ab.MAX_STEPS == 500_000
    csrc = os.path.join(ROOT, "icikit_torch", "csrc")
    argv = ["--a", csrc, "--b", csrc]
    monkeypatch.setattr(solitaire_ab.torch.cuda, "is_available",
                        lambda: True)
    for ok in (True, False):
        monkeypatch.setattr(solitaire_ab, "run", lambda *args, ok=ok: ok)
        assert solitaire_ab.main(argv) == (0 if ok else 1)
        assert solitaire_ab.main([*argv, "--timing-only"]) == 0
