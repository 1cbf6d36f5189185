#!/usr/bin/env python3
"""Drive icikit_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. device: the card's name and power limit (``nvidia-smi``).
2. build: the kernels from ``icikit_torch/csrc`` with ``nvcc`` (sm_90a).
3. kernels: each kernel held against its plain PyTorch version on the
   card: K1 and K2 alone, ``local_sort`` at 2^16 and 2^20 for int32,
   float32, uint32 and bfloat16 plus a non-power-of-two length, and
   ``merge_bitonic`` at 2^20. Integers must agree bitwise, floats by
   value (the tolerance is exact).
4. main: ``sort`` of 2^28 int32 keys with p = 1 (the headline): 0
   inversions, bitwise equal to ``torch.sort`` (an oracle only), both
   kernels launched; timed by the median-of-windows protocol beside
   ``torch.sort`` and the memory-bandwidth bound of its launches.
5. ranks: the rank-vectorised sort of 2^24 keys at p = 2, 4, 8, whose
   merges run K2's merge-only pass.
6. timed launches: K1 and K2 timed at the main path's shapes.
7. attention kernels held against their plain versions on the card:
   ``flash_fwd`` at (b, h, d) = (8, 8, 128), s = 512 and 768, and at
   (1, 8, 128), s = 2048, in bf16 and float32, causal and not;
   ``decode_step`` at 64 rows, dh 128, 576 columns, cur = 0, 1, 300,
   575, RoPE on and off, bf16 and float32. Tolerances: float32 out and
   lse 1e-4; bf16 out 2e-2 (P is rounded to bf16 before PV in the
   kernel, against its running row max) and lse 1e-3; the cache columns
   bitwise. TF32 is off for both matmul backends.
8. the decode path: ``greedy_generate`` of the ``base`` preset (random
   float32 masters from a seeded generator, bf16 compute), batch 8,
   prompt 512, 64 new tokens, decode_step="fused", attention "flash":
   12 ``flash_fwd`` and 756 ``decode_step`` launches asserted; held
   against the same generate through the plain arms JAX itself offers
   (decode_step "unfused", attention "dense"): at float32 the tokens
   must agree except after a near-tie (a top-2 logit gap below 1e-3 at
   the first differing step), at bf16 the first step's logits within
   0.25; then tokens/s by the chained median-of-windows protocol beside
   the unfused arm, prefill ms, the byte-model bound per token and the
   device's idle share from a ``torch.profiler`` trace.
9. per-kernel numbers of the decode path's kernels at its shapes.
10. train kernels held against their plain versions on the card:
   ``flash_fwd`` in constant-shift mode and ``flash_bwd`` at (8, 8,
   1024, 128) and (1, 8, 2048, 128), causal and full, plus q x 400
   (the overflow the kernel redoes online), bf16 and float32; the three
   cross-entropy kernels at T 8192, D 1024, V 32768. Tolerances are in
   the phase's line (FLASH_TOL, XENT_TOL).
11. the train path: ``make_train_step`` of the ``base`` preset (random
   float32 masters from a seeded generator), batch 8, s 1024, bf16,
   ``remat_policy="except_attn"``, ``softmax_shift=16``, the saved-exp
   fused head, ``FusedAdam(1e-4)`` with bf16 moments; tokens and targets
   from ``numpy.random.default_rng(0)``. 12 ``flash_fwd``, 12
   ``flash_bwd`` and one launch of each cross-entropy kernel per step
   asserted. At b = 2 the kernel arms are held against the plain arms
   (dense attention, unfused head) at float32: loss within 1e-4, every
   gradient leaf within a relative L2 error of 1e-3; the bf16 first-step
   loss within 1% of that; the loss falling over 5 steps. Then step ms,
   tokens/s and mfu by median-of-windows, and a ``torch.profiler``
   trace of one step (idle share, device time by kernel).
12. kernels line: every ported kernel with its launches on its main path,
   its time at that path's shapes, its plain version's time, a library
   call's time where one computes the same function, and its bound.

The line before the last is ``nvidia-smi``'s name and power limit; the
last is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time

# Published H100 SXM peaks (NVIDIA data sheet): device memory, and the
# 32-bit rate outside the tensor cores, used for the bound of a kernel's
# compare-exchange work (a compare-exchange counted as 2 operations).
MEM_BPS_SXM = 3.35e12
VECTOR_OPS = 67e12
BF16_TENSOR_OPS = 989e12
MULT = -1640531527

# Decode path (phase 8): the base preset at batch 8, prompt 512, 64 new.
DEC_PRESET, DEC_BATCH, DEC_PROMPT, DEC_NEW = "base", 8, 512, 64
FP32_LOGIT_TOL = 1e-3
BF16_LOGIT_TOL = 0.25

# Train path (phases 10-12): the base preset at batch 8, s = 1024.
TRAIN_PRESET, TRAIN_BATCH, TRAIN_CHECK_BATCH = "base", 8, 2
TRAIN_TOKENS = TRAIN_BATCH * 1024
TRAIN_LR = 1e-4
SHIFT = 16.0
# (b, h, s, d) of the path's flash launches, and the many-block regime
FLASH_SHAPES = {"B5-shift": (TRAIN_BATCH, 8, 1024, 128),
                "B4": (1, 8, 2048, 128)}
XENT_SHAPE = (TRAIN_TOKENS, 1024, 32768)   # (T, D, V) of the head
TRAIN_LOSS_TOL = 1e-4      # float32 kernel arms vs plain arms
TRAIN_GRAD_TOL = 1e-3      # relative L2, each gradient leaf
TRAIN_BF16_TOL = 1e-2      # bf16 first-step loss vs the fp32 plain arm
FLASH_TOL = {"bf16": {"out": 2e-2, "lse": 1e-3, "grad": 2e-2,
                      "grad_hot": 2e-2},
             "f32": {"out": 1e-4, "lse": 1e-4, "grad": 1e-4,
                     "grad_hot": 1e-3}}
XENT_TOL = {"bf16": {"lse": 1e-3, "grad": 2e-2},
            "f32": {"lse": 1e-4, "grad": 1e-4}}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60,
                       check=True)
    return q.stdout.strip().splitlines()[0]


def attention_checks(torch, dev) -> None:
    """Phase 7: each attention kernel against its plain version."""
    from icikit_torch.ops import cuda_attention as ca
    from icikit_torch.ops.rope import rope_sincos

    gen = torch.Generator(device=dev).manual_seed(2)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def err(a, b) -> float:
        return float((a.float() - b.float()).abs().max())

    checks = []
    for dtype, o_tol, l_tol in ((torch.bfloat16, 2e-2, 1e-3),
                                (torch.float32, 1e-4, 1e-4)):
        for b, h, s in ((8, 8, 512), (8, 8, 768), (1, 8, 2048)):
            q, k, v = (randn((b, h, s, 128), dtype) for _ in range(3))
            for causal in (True, False):
                out, lse = ca.flash_fwd(q, k, v, causal, 128 ** -0.5)
                want, want_lse = ca.flash_fwd_plain(q, k, v, causal,
                                                    128 ** -0.5)
                e_o, e_l = err(out, want), err(lse, want_lse)
                checks.append({"kernel": "flash_fwd", "dtype": str(dtype),
                               "shape": [b, h, s, 128], "causal": causal,
                               "out_err": e_o, "lse_err": e_l,
                               "ok": e_o <= o_tol and e_l <= l_tol})
            del q, k, v, out, lse, want, want_lse
        rows, total, dh = 64, 576, 128
        for rope in (True, False):
            for cur in (0, 1, 300, 575):
                q, k, v = (randn((rows, dh), dtype) for _ in range(3))
                kc, vc = (randn((rows, total, dh), dtype) for _ in range(2))
                c, s_ = rope_sincos(torch.tensor([cur], device=dev), dh)
                cos2, sin2 = torch.cat([c, c], -1), torch.cat([s_, s_], -1)
                kc2, vc2 = kc.clone(), vc.clone()
                got = ca.decode_step(q, k, v, kc, vc, cur, cos2, sin2,
                                     scale=dh ** -0.5, rope=rope)
                want = ca.decode_step_plain(q, k, v, kc2, vc2, cur, cos2,
                                            sin2, scale=dh ** -0.5,
                                            rope=rope)
                e_o = err(got, want)
                same = bool(torch.equal(kc, kc2) and torch.equal(vc, vc2))
                checks.append({"kernel": "decode_step", "dtype": str(dtype),
                               "rows": rows, "total": total, "cur": cur,
                               "rope": rope, "out_err": e_o,
                               "cache_bitwise": same,
                               "ok": e_o <= o_tol and same})
    torch.cuda.synchronize()
    emit({"phase": "attention_kernels",
          "tolerance": "float32 out and lse 1e-4; bf16 out 2e-2 (P is "
                       "rounded to bf16 before PV, against the kernel's "
                       "running row max and the plain version's final "
                       "one) and lse 1e-3; cache columns bitwise; TF32 "
                       "off",
          "checks": checks})
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise AssertionError(f"attention kernel disagrees with its plain "
                             f"version: {bad}")


def _first_divergence(tok_a, tok_b, lg_a, lg_b, s_prompt, tol):
    """Per row: the first new-token index where two generates differ,
    with the top-2 logit gap of each arm there (a near-tie when below
    ``tol``), and the largest logit difference up to that step."""
    rows = []
    for r in range(tok_a.shape[0]):
        diff = (tok_a[r, s_prompt:] != tok_b[r, s_prompt:]).nonzero()
        j = int(diff[0]) if diff.numel() else None
        upto = tok_a.shape[1] - s_prompt if j is None else j + 1
        max_d = float((lg_a[:upto, r] - lg_b[:upto, r]).abs().max())
        row = {"row": r, "first_diff": j, "max_logit_diff": max_d}
        if j is not None:
            gaps = [float(t[0] - t[1]) for t in (
                lg_a[j, r].topk(2).values, lg_b[j, r].topk(2).values)]
            row["top2_gap"] = gaps
            row["near_tie"] = max(gaps) < tol
        rows.append(row)
    return rows


def decode_path(torch, dev, bw, smi) -> dict:
    """Phase 8: the decode path at the base preset; returns the kernel
    launches of its main run."""
    from icikit_torch.bench.decode import decode_bytes_per_token, make_config
    from icikit_torch.models.transformer import (greedy_generate,
                                                 init_params,
                                                 make_model_mesh)
    from icikit_torch.ops import cuda_attention as ca
    from icikit_torch.utils.timing import cuda_time_ms, timeit_windows
    from icikit_torch.utils.trace import device_activity

    t0 = time.perf_counter()
    mesh = make_model_mesh(device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    plain = dict(decode_step="unfused", attention_impl="dense")

    def config(dtype, **over):
        return make_config(DEC_PRESET, DEC_PROMPT, DEC_NEW,
                           **{"decode_step": "fused",
                              "attention_impl": "flash",
                              "compute_dtype": dtype, **over})

    cfg = config("bfloat16")
    params = init_params(cfg, gen, dev)
    prompt = torch.randint(0, cfg.vocab, (DEC_BATCH, DEC_PROMPT),
                           generator=gen, device=dev, dtype=torch.int32)

    # the main path's run, counted
    greedy_generate(params, prompt, mesh, cfg, 2)  # first-call set-up
    torch.cuda.synchronize()
    ca.reset_launches()
    out, lg16 = greedy_generate(params, prompt, mesh, cfg, DEC_NEW,
                                return_logits=True)
    torch.cuda.synchronize()
    launches = dict(ca.LAUNCHES)
    want = {"flash_fwd": cfg.n_layers, "flash_bwd": 0,
            "decode_step": cfg.n_layers * (DEC_NEW - 1)}
    if launches != want:
        raise AssertionError(f"decode path launches {launches}, want "
                             f"{want}")
    ok_shape = (tuple(out.shape) == (DEC_BATCH, DEC_PROMPT + DEC_NEW)
                and bool(torch.equal(out[:, :DEC_PROMPT], prompt))
                and int(out.min()) >= 0 and int(out.max()) < cfg.vocab
                and bool(torch.isfinite(lg16).all()))
    if not ok_shape:
        raise AssertionError("decode path output malformed")

    # bf16 against the plain arms: first-step logits, token agreement
    out_p, lg16_p = greedy_generate(params, prompt, mesh,
                                    config("bfloat16", **plain), DEC_NEW,
                                    return_logits=True)
    d16 = (lg16[0] - lg16_p[0]).abs()
    bf16 = {"first_logits_max_diff": float(d16.max()),
            "first_logits_mean_diff": float(d16.mean()),
            "tolerance": BF16_LOGIT_TOL,
            "first_token_equal_share": float(
                (out[:, DEC_PROMPT] == out_p[:, DEC_PROMPT]).float().mean()),
            "token_equal_share": float(
                (out[:, DEC_PROMPT:] == out_p[:, DEC_PROMPT:]).float()
                .mean())}
    del lg16, lg16_p

    # float32: tokens identical up to near-ties
    t32, lg32 = greedy_generate(params, prompt, mesh, config("float32"),
                                DEC_NEW, return_logits=True)
    t32p, lg32p = greedy_generate(params, prompt, mesh,
                                  config("float32", **plain), DEC_NEW,
                                  return_logits=True)
    rows = _first_divergence(t32, t32p, lg32, lg32p, DEC_PROMPT,
                             FP32_LOGIT_TOL)
    fp32 = {"tokens_identical": bool(torch.equal(t32, t32p)),
            "logit_tolerance": FP32_LOGIT_TOL, "rows": rows}
    del lg32, lg32p
    emit({"phase": "decode_check", "preset": DEC_PRESET, "batch": DEC_BATCH,
          "prompt": DEC_PROMPT, "n_new": DEC_NEW, "launches": launches,
          "bf16": bf16, "fp32": fp32,
          "seconds": round(time.perf_counter() - t0, 1)})
    bad32 = [r for r in rows if r["max_logit_diff"] > FP32_LOGIT_TOL
             or (r["first_diff"] is not None and not r["near_tie"])]
    if bad32 or bf16["first_logits_max_diff"] > BF16_LOGIT_TOL:
        raise AssertionError(f"decode path disagrees with its plain arms: "
                             f"fp32 {bad32}, bf16 {bf16}")

    # timing: the fused arm and the unfused arm, the same protocol
    ctr = [0]

    def chain(args, o):
        ctr[0] += 1
        nxt = o[:, -DEC_PROMPT:].clone()
        nxt[0, 0] = ctr[0] % cfg.vocab
        return (nxt,)

    per_token_bytes = decode_bytes_per_token(cfg, DEC_BATCH,
                                             DEC_PROMPT + DEC_NEW)
    floor_s = DEC_NEW * per_token_bytes / bw
    arms = {}
    for name, c in (("fused", cfg),
                    ("unfused", config("bfloat16",
                                       decode_step="unfused"))):
        res = timeit_windows(
            lambda p, c=c: greedy_generate(params, p, mesh, c, DEC_NEW),
            (prompt,), chain, windows=3, runs=2, warmup=1, floor_s=floor_s)
        arms[name] = {"per_token_ms": res.median_s / DEC_NEW * 1e3,
                      "spread_ms": [res.min_s / DEC_NEW * 1e3,
                                    res.max_s / DEC_NEW * 1e3],
                      "tokens_per_s": DEC_BATCH * DEC_NEW / res.median_s,
                      "generate_ms": res.median_s * 1e3,
                      "windows": res.windows, "suspect": res.suspect}
    prefill_ms = cuda_time_ms(
        lambda: greedy_generate(params, prompt, mesh, cfg, 1), iters=5)
    activity = device_activity(
        lambda: greedy_generate(params, prompt, mesh, cfg, DEC_NEW))
    emit({"phase": "decode_timing", "card": smi, "arms": arms,
          "prefill_ms": prefill_ms,
          "step_ms_excluding_prefill": (arms["fused"]["generate_ms"]
                                        - prefill_ms) / (DEC_NEW - 1),
          "bound_ms_per_token": per_token_bytes / bw * 1e3,
          "bytes_per_token": per_token_bytes,
          "read_gbps": per_token_bytes
          / (arms["fused"]["per_token_ms"] * 1e-3) / 1e9,
          "profile": activity,
          "seconds": round(time.perf_counter() - t0, 1)})
    return launches


def attention_rows(torch, dev, bw, launches) -> list:
    """Phase 9's rows for the attention kernels, timed at the decode
    path's shapes."""
    import torch.nn.functional as F

    from icikit_torch.ops import cuda_attention as ca
    from icikit_torch.utils.timing import cuda_time_ms

    gen = torch.Generator(device=dev).manual_seed(3)
    b, h, s, d = DEC_BATCH, 8, DEC_PROMPT, 128  # the base preset's heads
    scale = d ** -0.5
    q, k, v = (torch.randn((b, h, s, d), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    f_ms = cuda_time_ms(lambda: ca.flash_fwd(q, k, v, True, scale),
                        iters=50, warmup=5)
    f_plain = cuda_time_ms(lambda: ca.flash_fwd_plain(q, k, v, True, scale),
                           iters=5)
    f_lib = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=scale), iters=50, warmup=5)
    f_err = float((ca.flash_fwd(q, k, v, True, scale)[0].float()
                   - ca.flash_fwd_plain(q, k, v, True, scale)[0].float())
                  .abs().max())
    pairs = b * h * s * (s + 1) // 2            # causal (q, k) pairs
    f_bytes = 4 * b * h * s * d * 2 + b * h * s * 4
    f_ops = 2 * 2 * d * pairs                   # QK^T and PV
    f_bound = max(f_bytes / bw, f_ops / BF16_TENSOR_OPS) * 1e3
    f_by = "bytes" if f_bytes / bw >= f_ops / BF16_TENSOR_OPS \
        else "operations"

    rows, total, dh = b * h, DEC_PROMPT + DEC_NEW, 128
    cur = DEC_PROMPT + (DEC_NEW - 1) // 2       # the steps' mean column
    dq, dk, dv = (torch.randn((rows, dh), generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(3))
    kc, vc = (torch.randn((rows, total, dh), generator=gen, device=dev)
              .to(torch.bfloat16) for _ in range(2))
    cos2 = torch.ones((1, dh), device=dev)
    sin2 = torch.zeros((1, dh), device=dev)
    d_ms = cuda_time_ms(lambda: ca.decode_step(
        dq, dk, dv, kc, vc, cur, cos2, sin2, scale=scale, rope=True),
        iters=100, warmup=5)
    d_plain = cuda_time_ms(lambda: ca.decode_step_plain(
        dq, dk, dv, kc, vc, cur, cos2, sin2, scale=scale, rope=True),
        iters=10)
    d_err = float((ca.decode_step(dq, dk, dv, kc, vc, cur, cos2, sin2,
                                  scale=scale, rope=True).float()
                   - ca.decode_step_plain(dq, dk, dv, kc.clone(), vc.clone(),
                                          cur, cos2, sin2, scale=scale,
                                          rope=True).float()).abs().max())
    d_bytes = (2 * rows * cur * dh * 2          # K and V past columns
               + 3 * rows * dh * 2 + rows * dh * 2  # q, k, v in, out
               + 2 * rows * dh * 2 + 2 * dh * 4)    # column writes, tables
    d_ops = 2 * 2 * rows * (cur + 1) * dh       # logits and PV, float32
    d_bound = max(d_bytes / bw, d_ops / VECTOR_OPS) * 1e3
    d_by = "bytes" if d_bytes / bw >= d_ops / VECTOR_OPS else "operations"
    torch.cuda.synchronize()
    emit({"phase": "attention_timing",
          "flash_fwd": f"b={b} h={h} s={s} d={d} bf16 causal",
          "decode_step": f"rows={rows} total={total} dh={dh} cur={cur} "
                         f"bf16 rope",
          "decode_step_library": "none: no one PyTorch call applies RoPE, "
                                 "writes the cache column and attends"})
    return [
        {"name": "flash_fwd (B3/B5)", "route": "cuda",
         "source": "icikit_torch/csrc/attention.cu",
         "replaces": "icikit/ops/flash_attention.py:421 (B3), :349 (B5)",
         "launches": launches["flash_fwd"], "max_abs_err": f_err,
         "ms": f_ms, "plain_ms": f_plain, "bound_ms": f_bound,
         "bound_by": f_by, "library_ms": f_lib},
        {"name": "decode_step (B13)", "route": "cuda",
         "source": "icikit_torch/csrc/attention.cu",
         "replaces": "icikit/ops/flash_attention.py:1120",
         "launches": launches["decode_step"], "max_abs_err": d_err,
         "ms": d_ms, "plain_ms": d_plain, "bound_ms": d_bound,
         "bound_by": d_by, "library_ms": None},
    ]


def _rel(a, b) -> float:
    """Largest |a - b| over the largest |b|."""
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


def _rel_l2(a, b) -> float:
    """||a - b|| / ||b|| in float64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def train_kernel_checks(torch, dev) -> None:
    """Phase 10: the train path's kernels against their plain versions
    on the card, at the path's shapes and the many-block (B4/B7) shape."""
    from icikit_torch.ops import cuda_attention as ca
    from icikit_torch.ops import cuda_xent as cx

    gen = torch.Generator(device=dev).manual_seed(4)

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    def err(a, b) -> float:
        return float((a.float() - b.float()).abs().max())

    checks = []
    for dtype, tol in ((torch.bfloat16, FLASH_TOL["bf16"]),
                       (torch.float32, FLASH_TOL["f32"])):
        for b, h, s, d in FLASH_SHAPES.values():
            q, k, v, do = (randn((b, h, s, d), dtype) for _ in range(4))
            scale = d ** -0.5
            for causal, hot in ((True, False), (False, False), (True, True)):
                qq = (q.float() * 400.0).to(dtype) if hot else q
                out, lse = ca.flash_fwd(qq, k, v, causal, scale,
                                        shift=SHIFT)
                w_out, w_lse = ca.flash_fwd_plain(qq, k, v, causal, scale,
                                                  shift=SHIFT)
                delta = (do.float() * out.float()).sum(-1)
                got = ca.flash_bwd(qq, k, v, do, lse, delta, causal, scale)
                want = ca.flash_bwd_plain(qq, k, v, do, lse, delta, causal,
                                          scale)
                e_o = err(out, w_out)
                e_l = err(lse, w_lse) / (float(w_lse.abs().max())
                                         if hot else 1.0)
                e_g = max(_rel(a, c) for a, c in zip(got, want))
                finite = bool(torch.isfinite(lse).all()) and all(
                    bool(torch.isfinite(g.float()).all()) for g in got)
                g_tol = tol["grad_hot"] if hot else tol["grad"]
                checks.append({
                    "kernel": "flash_fwd shift + flash_bwd",
                    "dtype": str(dtype), "shape": [b, h, s, d],
                    "causal": causal, "q_times_400": hot, "out_err": e_o,
                    "lse_err": e_l, "grad_rel_err": e_g, "finite": finite,
                    "ok": finite and e_o <= tol["out"]
                    and e_l <= tol["lse"] and e_g <= g_tol})
            del q, k, v, do, out, lse, w_out, w_lse, got, want, delta
    t, d, v = XENT_SHAPE
    for dtype, tol in ((torch.bfloat16, XENT_TOL["bf16"]),
                       (torch.float32, XENT_TOL["f32"])):
        x = randn((t, d), dtype)
        w = randn((v, d), dtype, d ** -0.5)
        tg = torch.randint(0, v, (t,), generator=gen, device=dev,
                           dtype=torch.int32)
        dn = randn((t,), torch.float32, 1.0 / t)
        lse, tgt, e, mrun = cx.xent_fwd(x, w, tg, save=True)
        chunk = cx.TILE[dtype]
        p_lse, p_tgt, p_e, p_m = cx.xent_fwd_plain(x, w, tg, True, chunk)
        e_l = max(err(lse, p_lse), err(tgt, p_tgt))
        dx = cx.xent_dx_saved(e, mrun, w, tg, lse, dn)
        e_dx = _rel(dx, cx.xent_dx_saved_plain(p_e, p_m, w, tg, p_lse, dn,
                                               chunk))
        dw = cx.xent_dw_saved(e, mrun, x, tg, lse, dn)
        e_dw = _rel(dw, cx.xent_dw_saved_plain(p_e, p_m, x, tg, p_lse, dn,
                                               chunk))
        checks.append({"kernel": "xent_fwd + xent_dx_saved + xent_dw_saved",
                       "dtype": str(dtype), "shape": [t, d, v],
                       "lse_tgt_err": e_l, "dx_rel_err": e_dx,
                       "dw_rel_err": e_dw,
                       "ok": e_l <= tol["lse"] and e_dx <= tol["grad"]
                       and e_dw <= tol["grad"]})
        del x, w, e, mrun, p_e, p_m, dx, dw
    torch.cuda.synchronize()
    emit({"phase": "train_kernels", "shift": SHIFT,
          "tolerance": {"flash": FLASH_TOL, "xent": XENT_TOL,
                        "why": "float32: sums in other orders, dq by "
                               "atomics; bf16: P and dS rounded to bf16 "
                               "against lse values that differ in the "
                               "last bits, and g rounded to bf16 for "
                               "the tensor cores where the plain "
                               "version contracts it in float32; q x 400: "
                               "logits of ~400 nats, where one float32 "
                               "ulp of the lse moves P by 3e-5; lse "
                               "errors there relative to the largest "
                               "|lse|; TF32 off"},
          "checks": checks})
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise AssertionError(f"train kernel disagrees with its plain "
                             f"version: {bad}")


def _train_config(dtype, **over):
    from icikit_torch.bench.train import PRESETS
    from icikit_torch.models.transformer import TransformerConfig
    return TransformerConfig(**PRESETS[TRAIN_PRESET], compute_dtype=dtype,
                             remat_policy="except_attn",
                             softmax_shift=SHIFT, **over)


def train_path(torch, dev, smi) -> dict:
    """Phase 11: the train step of the base preset; returns the kernel
    launches of its counted step."""
    import numpy as np

    from icikit_torch.bench.train import detect_peak, step_flops
    from icikit_torch.models.transformer import (FusedAdam, init_params,
                                                 loss_and_metrics,
                                                 make_model_mesh,
                                                 make_train_step)
    from icikit_torch.ops import cuda_attention as ca
    from icikit_torch.ops import cuda_xent as cx
    from icikit_torch.utils.timing import timeit_windows
    from icikit_torch.utils.trace import device_activity

    t0 = time.perf_counter()
    mesh = make_model_mesh(device=dev)
    cfg = _train_config("bfloat16")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    rng = np.random.default_rng(0)
    seq = cfg.max_seq
    tok, tgt = (torch.from_numpy(rng.integers(0, cfg.vocab,
                                              (TRAIN_BATCH, seq))
                                 .astype(np.int32)).to(dev)
                for _ in range(2))

    # correctness at b = 2, full width and depth: the kernel arms against
    # the plain arms (dense attention, unfused head) at float32
    b2 = (tok[:TRAIN_CHECK_BATCH], tgt[:TRAIN_CHECK_BATCH])
    loss_k, g_k, _ = loss_and_metrics(params, *b2, mesh,
                                      _train_config("float32"))
    loss_p, g_p, _ = loss_and_metrics(
        params, *b2, mesh, _train_config("float32", attention_impl="dense",
                                         fused_head=False))
    leaf_err = {k: _rel_l2(g_k[k], g_p[k]) for k in g_p}
    del g_k, g_p
    loss_b, _, _ = loss_and_metrics(params, *b2, mesh, cfg)
    fp32 = {"loss_kernels": float(loss_k), "loss_plain": float(loss_p),
            "loss_diff": abs(float(loss_k) - float(loss_p)),
            "loss_tolerance": TRAIN_LOSS_TOL,
            "grad_rel_l2_max": max(leaf_err.values()),
            "grad_rel_l2": leaf_err, "grad_tolerance": TRAIN_GRAD_TOL}
    bf16_first = {"loss": float(loss_b),
                  "rel_diff_to_fp32_plain":
                      abs(float(loss_b) - float(loss_p)) / float(loss_p),
                  "tolerance": TRAIN_BF16_TOL}

    # the main path: b = 8 bf16 steps, the second one counted
    opt, step = make_train_step(
        mesh, cfg, FusedAdam(TRAIN_LR, mu_dtype=torch.bfloat16,
                             nu_dtype=torch.bfloat16))
    st = opt.init(params)
    losses = []
    params, st, loss = step(params, st, tok, tgt)  # first-call set-up
    losses.append(float(loss))
    ca.reset_launches()
    cx.reset_launches()
    params, st, loss = step(params, st, tok, tgt)
    torch.cuda.synchronize()
    launches = {**ca.LAUNCHES, **cx.LAUNCHES}
    losses.append(float(loss))
    want = {"flash_fwd": cfg.n_layers, "flash_bwd": cfg.n_layers,
            "decode_step": 0, "xent_fwd": 1, "xent_dx_saved": 1,
            "xent_dw_saved": 1}
    if launches != want:
        raise AssertionError(f"train path launches {launches}, want {want}")
    for _ in range(3):
        params, st, loss = step(params, st, tok, tgt)
        losses.append(float(loss))
    emit({"phase": "train_check", "preset": TRAIN_PRESET,
          "batch": TRAIN_BATCH, "seq": seq, "check_batch": TRAIN_CHECK_BATCH,
          "launches_per_step": launches, "fp32": fp32,
          "bf16_first_step": bf16_first, "bf16_losses_5_steps": losses,
          "seconds": round(time.perf_counter() - t0, 1)})
    ok = (fp32["loss_diff"] <= TRAIN_LOSS_TOL
          and fp32["grad_rel_l2_max"] <= TRAIN_GRAD_TOL
          and bf16_first["rel_diff_to_fp32_plain"] <= TRAIN_BF16_TOL
          and all(np.isfinite(losses)) and losses[-1] < losses[0])
    if not ok:
        raise AssertionError(f"train path disagrees with its plain arms or "
                             f"does not learn: fp32 {fp32}, bf16 "
                             f"{bf16_first}, losses {losses}")

    # timing: chained steps carried in place, median of windows of at
    # least 1.5 s (a step is ~0.1 s, and host noise spreads short windows)
    n_steps = 5
    flops = step_flops(cfg, TRAIN_BATCH, seq)
    peak = detect_peak(dev)

    def multi(p, s):
        out = (p, s, None)
        for _ in range(n_steps):
            out = step(out[0], out[1], tok, tgt)
        return out

    res = timeit_windows(multi, (params, st), lambda a, o: (o[0], o[1]),
                         windows=3, runs=1, warmup=1, target_window_s=1.5,
                         floor_s=n_steps * flops / peak if peak else None)
    step_s = res.median_s / n_steps
    activity = device_activity(lambda: step(params, st, tok, tgt))
    emit({"phase": "train_timing", "card": smi,
          "step_ms": step_s * 1e3,
          "step_ms_spread": [res.min_s / n_steps * 1e3,
                             res.max_s / n_steps * 1e3],
          "windows": res.windows, "suspect": res.suspect,
          "tokens_per_s": TRAIN_BATCH * seq / step_s,
          "model_tflops_per_s": flops / step_s / 1e12,
          "mfu": flops / step_s / peak if peak else None,
          "step_flops": flops, "peak_flops": peak,
          "bound_ms": flops / BF16_TENSOR_OPS * 1e3,
          "profile": activity,
          "seconds": round(time.perf_counter() - t0, 1)})
    return launches


def train_rows(torch, dev, bw, launches) -> list:
    """Phase 12's rows for the train path's kernels: each timed at the
    path's shapes (and B4/B7 at the many-block shape), beside its plain
    version, a library call and its bound."""
    import torch.nn.functional as F

    from icikit_torch.ops import cuda_attention as ca
    from icikit_torch.ops import cuda_xent as cx
    from icikit_torch.utils.timing import cuda_time_ms

    gen = torch.Generator(device=dev).manual_seed(5)
    bf = torch.bfloat16

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(bf)

    def bound(nbytes, ops):
        t_b, t_o = nbytes / bw, ops / BF16_TENSOR_OPS
        return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"

    rows, notes = [], {}
    for tag, (b, h, s, d) in FLASH_SHAPES.items():
        q, k, v, do = (randn((b, h, s, d)) for _ in range(4))
        scale = d ** -0.5
        pairs = b * h * s * (s + 1) // 2
        f_ms = cuda_time_ms(lambda: ca.flash_fwd(q, k, v, True, scale,
                                                 shift=SHIFT),
                            iters=50, warmup=5)
        f_plain = cuda_time_ms(lambda: ca.flash_fwd_plain(
            q, k, v, True, scale, shift=SHIFT), iters=5)
        f_lib = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale), iters=50, warmup=5)
        out, lse = ca.flash_fwd(q, k, v, True, scale, shift=SHIFT)
        f_err = float((out.float() - ca.flash_fwd_plain(
            q, k, v, True, scale, shift=SHIFT)[0].float()).abs().max())
        f_bound, f_by = bound(4 * b * h * s * d * 2 + b * h * s * 4,
                              2 * 2 * d * pairs)
        rows.append({"name": f"flash_fwd shift ({tag})", "route": "cuda",
                     "source": "icikit_torch/csrc/attention.cu",
                     "replaces": ("icikit/ops/flash_attention.py:349 (B5, "
                                  "shift branch :328)" if tag == "B5-shift"
                                  else "icikit/ops/flash_attention.py:421 "
                                       "(B4, _fwd_const_kernel :230)"),
                     "launches": launches["flash_fwd"], "max_abs_err": f_err,
                     "ms": f_ms, "plain_ms": f_plain, "bound_ms": f_bound,
                     "bound_by": f_by, "library_ms": f_lib})
        delta = (do.float() * out.float()).sum(-1)
        b_ms = cuda_time_ms(lambda: ca.flash_bwd(q, k, v, do, lse, delta,
                                                 True, scale),
                            iters=20, warmup=3)
        b_plain = cuda_time_ms(lambda: ca.flash_bwd_plain(
            q, k, v, do, lse, delta, True, scale), iters=3)
        b_err = max(_rel(a, c) for a, c in zip(
            ca.flash_bwd(q, k, v, do, lse, delta, True, scale),
            ca.flash_bwd_plain(q, k, v, do, lse, delta, True, scale)))
        lq, lk, lv = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True,
                                            scale=scale)
        b_lib = cuda_time_ms(lambda: torch.autograd.grad(
            lo, (lq, lk, lv), do, retain_graph=True), iters=20, warmup=3)
        b_bound, b_by = bound(7 * b * h * s * d * 2 + 2 * b * h * s * 4,
                              5 * 2 * d * pairs)
        btag = "B6" if tag == "B5-shift" else "B7"
        rows.append({"name": f"flash_bwd ({btag})", "route": "cuda",
                     "source": "icikit_torch/csrc/attention.cu",
                     "replaces": ("icikit/ops/flash_attention.py:701 (B6)"
                                  if btag == "B6" else
                                  "icikit/ops/flash_attention.py:653 (B7)"),
                     "launches": launches["flash_bwd"],
                     "max_abs_err": b_err,
                     "ms": b_ms, "plain_ms": b_plain, "bound_ms": b_bound,
                     "bound_by": b_by, "library_ms": b_lib})
        notes[tag] = f"b={b} h={h} s={s} d={d} bf16 causal shift={SHIFT}"
        del q, k, v, do, out, lse, delta, lq, lk, lv, lo

    t, d, v = XENT_SHAPE
    x = randn((t, d))
    w = randn((v, d), d ** -0.5)
    tg = torch.randint(0, v, (t,), generator=gen, device=dev,
                       dtype=torch.int32)
    dn = torch.full((t,), 1.0 / t, device=dev)
    ops = 2 * t * v * d
    chunk = cx.TILE[bf]
    fx_ms = cuda_time_ms(lambda: cx.xent_fwd(x, w, tg, save=True), iters=10)
    fx_plain = cuda_time_ms(lambda: cx.xent_fwd_plain(x, w, tg, True, chunk),
                            iters=3)
    lse, tgt, e, mrun = cx.xent_fwd(x, w, tg, save=True)
    fx_err = float((lse - cx.xent_fwd_plain(x, w, tg, True, chunk)[0])
                   .abs().max())
    mm_ms = cuda_time_ms(lambda: torch.matmul(x, w.t()), iters=10)
    nc = -(-v // chunk)
    fx_bound, fx_by = bound(t * d * 2 + v * d * 2 + t * 4 + 2 * t * 4
                            + t * v * 2 + nc * t * 4, ops)
    rows.append({"name": "xent_fwd (B9)", "route": "cuda",
                 "source": "icikit_torch/csrc/xent.cu",
                 "replaces": "icikit/ops/xent.py:283 (B9)",
                 "launches": launches["xent_fwd"], "max_abs_err": fx_err,
                 "ms": fx_ms, "plain_ms": fx_plain, "bound_ms": fx_bound,
                 "bound_by": fx_by, "library_ms": None})
    for which, fn, plain, other, out_rows in (
            ("dx", cx.xent_dx_saved, cx.xent_dx_saved_plain, w, t),
            ("dw", cx.xent_dw_saved, cx.xent_dw_saved_plain, x, v)):
        k_ms = cuda_time_ms(lambda: fn(e, mrun, other, tg, lse, dn),
                            iters=10)
        p_ms = cuda_time_ms(lambda: plain(e, mrun, other, tg, lse, dn, chunk),
                            iters=3)
        k_err = _rel(fn(e, mrun, other, tg, lse, dn),
                     plain(e, mrun, other, tg, lse, dn, chunk))
        k_bound, k_by = bound(t * v * 2 + nc * t * 4 + other.numel() * 2
                              + 3 * t * 4 + out_rows * d * 2, ops)
        rows.append({"name": f"xent_{which}_saved (B10)", "route": "cuda",
                     "source": "icikit_torch/csrc/xent.cu",
                     "replaces": ("icikit/ops/xent.py:374 (B10)"
                                  if which == "dx"
                                  else "icikit/ops/xent.py:411 (B10)"),
                     "launches": launches[f"xent_{which}_saved"],
                     "max_abs_err": k_err, "ms": k_ms, "plain_ms": p_ms,
                     "bound_ms": k_bound, "bound_by": k_by,
                     "library_ms": None})
    torch.cuda.synchronize()
    emit({"phase": "train_timing_kernels", **notes,
          "xent": f"T={t} D={d} V={v} bf16, saved flavour",
          "xent_library": "none: no one PyTorch call forms the logits, "
                          "their lse and target, or dx/dw from saved "
                          "exponentials; torch.matmul of x w^T alone "
                          "(cuBLAS) beside it",
          "matmul_x_wT_ms": mm_ms,
          "flash_bwd_library": "SDPA's backward through autograd on the "
                               "same tensors",
          "max_abs_err_of_bwd_and_dx_dw": "relative to the largest entry"})
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from icikit_torch.bench.sort import hbm_nameplate_bytes
    from icikit_torch.models.sort import check_sort, sort
    from icikit_torch.ops import _build
    from icikit_torch.ops import cuda_sort as cs
    from icikit_torch.utils.mesh import make_mesh
    from icikit_torch.utils.timing import cuda_time_ms, timeit_windows

    t_start = time.perf_counter()
    dev = "cuda"
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    emit({"phase": "device", "torch_name": kind, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    bw = hbm_nameplate_bytes(kind) or MEM_BPS_SXM

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build()
    regs = {}
    for which, name in ((0, "net_kernel<int>"), (1, "cross_kernel<int>")):
        r, loc = ctypes.c_int(), ctypes.c_int()
        _build.check(libs["bitonic_net"].icikit_kernel_regs(
            which, ctypes.byref(r), ctypes.byref(loc)), "kernel attributes")
        regs[name] = {"registers": r.value, "local_bytes": loc.value}
    for lib, fn, names in (
            ("attention", "icikit_attention_regs",
             ("flash_fwd_bf16<128>", "flash_fwd_f32<128>",
              "decode_step_kernel<bf16, 4>", "flash_bwd_bf16<128>",
              "flash_bwd_f32<128>")),
            ("xent", "icikit_xent_regs",
             ("xent_fwd_bf16", "xent_dx_bf16", "xent_dw_bf16",
              "xent_fwd_f32"))):
        for which, name in enumerate(names):
            r, loc = ctypes.c_int(), ctypes.c_int()
            _build.check(getattr(libs[lib], fn)(
                which, ctypes.byref(r), ctypes.byref(loc)),
                "kernel attributes")
            regs[name] = {"registers": r.value, "local_bytes": loc.value}
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 2),
          "log": {k: {"seconds": round(v["seconds"], 2),
                      "cached": v["cached"]}
                  for k, v in _build.BUILD_LOG.items()},
          "kernels": regs})

    # -- 3. kernels against their plain versions ------------------------
    gen = torch.Generator(device=dev).manual_seed(1)

    def rand(n, dtype):
        if dtype in (torch.float32, torch.bfloat16):
            return torch.randn(n, generator=gen, device=dev).to(dtype)
        if dtype == torch.uint32:
            return torch.randint(-2**31, 2**31 - 1, (n,), generator=gen,
                                 dtype=torch.int32, device=dev
                                 ).view(torch.uint32)
        return torch.randint(-2**31, 2**31 - 1, (n,), generator=gen,
                             dtype=torch.int32, device=dev)

    def same(a, b) -> bool:
        if a.dtype == torch.uint32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if a.dtype in (torch.float32, torch.bfloat16):
            return bool(torch.equal(a.float(), b.float()))
        return bool(torch.equal(a, b))

    def max_err(a, b) -> float:
        if a.dtype == torch.uint32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        return float((a.double() - b.double()).abs().max())

    checks = []
    cs.reset_launches()
    t = cs.T_GRID
    for dtype in (torch.int32, torch.float32):
        x = rand(t, dtype)
        rounds = cs._sort_rounds(cs.ilog2(t))
        got = cs.net_pass(x, t, rounds)
        want = cs.net_pass_plain(x, t, rounds)
        checks.append(("net_pass single tile", str(dtype), t,
                       same(got, want) and same(got, torch.sort(x).values)))
        span = 1 << 20
        x = rand(span * 2, dtype)
        for lo, hi in ((0, 6), (0, 0), (3, 6)):
            for mo in (False, True):
                got = cs.cross_pass(x, span, t, lo, hi, mo)
                want = cs.cross_pass_plain(x, span, t, lo, hi, mo)
                checks.append((f"cross_pass bits[{lo},{hi}] merge={mo}",
                               str(dtype), span * 2, same(got, want)))
    for n in (1 << 16, 1 << 20):
        for dtype in (torch.int32, torch.float32, torch.uint32,
                      torch.bfloat16):
            x = rand(n, dtype)
            got = cs.local_sort(x)
            want = cs.local_sort(x, plain=True)
            checks.append(("local_sort", str(dtype), n, same(got, want)))
    x = rand(1_000_003, torch.int32)
    got = cs.local_sort(x)
    checks.append(("local_sort non-pow2", "torch.int32", x.numel(),
                   same(got, cs.local_sort(x, plain=True))))
    a = torch.sort(rand(1 << 19, torch.int32)).values
    b = torch.sort(rand(1 << 19, torch.int32), descending=True).values
    v = torch.cat([a, b])
    checks.append(("merge_bitonic", "torch.int32", v.numel(),
                   same(cs.merge_bitonic(v),
                        cs.merge_bitonic(v, plain=True))))
    torch.cuda.synchronize()
    emit({"phase": "kernels",
          "tolerance": "exact: integers bitwise, floats by value",
          "checks": [{"what": w, "dtype": d, "n": n, "ok": ok}
                     for w, d, n, ok in checks],
          "launches": dict(cs.LAUNCHES)})
    bad = [c for c in checks if not c[3]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{bad}")

    # -- 4. the main path: sort 2^28 int32 keys, p = 1 -----------------
    n = 1 << 28
    mesh = make_mesh(1, device=dev)
    keys = torch.randint(-2**31, 2**31 - 1, (n,),
                         generator=torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    cs.reset_launches()
    out = sort(keys, mesh, algorithm="bitonic")
    torch.cuda.synchronize()
    main_launches = dict(cs.LAUNCHES)
    inversions = check_sort(out.reshape(1, -1), mesh)
    oracle = torch.sort(keys).values
    equal = bool(torch.equal(out, oracle))
    del oracle
    if inversions != 0 or not equal:
        raise AssertionError(f"main path: {inversions} inversions, "
                             f"equal to oracle: {equal}")
    if main_launches["net"] == 0 or main_launches["cross"] == 0:
        raise AssertionError(f"main path skipped a kernel: {main_launches}")
    del out

    def run(x):
        return sort(x, mesh, algorithm="bitonic")

    res = timeit_windows(run, (keys,), lambda a, o: (o * MULT,),
                         windows=3, runs=2, warmup=1)
    lib_ms = cuda_time_ms(lambda: torch.sort(keys), iters=5, warmup=1)
    per_sort = main_launches["net"] + main_launches["cross"]
    bound_ms = per_sort * 2 * n * 4 / bw * 1e3
    emit({"phase": "main", "n": n, "p": 1, "dtype": "int32",
          "inversions": inversions, "equal_to_oracle": equal,
          "launches_per_sort": main_launches,
          "median_ms": res.median_s * 1e3,
          "spread_ms": [res.min_s * 1e3, res.max_s * 1e3],
          "windows": res.windows, "keys_per_s": n / res.median_s,
          "library_ms": lib_ms, "bound_ms": bound_ms,
          "bound_by": "bytes", "nameplate_Bps": bw})

    # -- 5. rank-vectorised sort, p = 2, 4, 8 --------------------------
    ranks = []
    x = keys[: 1 << 24].clone()
    oracle = torch.sort(x).values
    for p in (2, 4, 8):
        cs.reset_launches()
        m = make_mesh(p, device=dev)
        o = sort(x, m, algorithm="bitonic")
        torch.cuda.synchronize()
        inv = check_sort(o.reshape(p, -1), m)
        eq = bool(torch.equal(o, oracle))
        ranks.append({"p": p, "n": x.numel(), "inversions": inv,
                      "equal_to_oracle": eq, "launches": dict(cs.LAUNCHES)})
        if inv != 0 or not eq or cs.LAUNCHES["cross"] == 0:
            raise AssertionError(f"rank sort p={p}: {ranks[-1]}")
    emit({"phase": "ranks", "runs": ranks})

    # -- 6. per-kernel numbers at the main path's shapes ---------------
    log2t = cs.ilog2(cs.T_GRID)
    buf = torch.empty_like(keys)
    rounds = cs._sort_rounds(log2t)
    stages = sum(len(s) for _, s in rounds)
    k1_ms = cuda_time_ms(lambda: cs.net_pass(keys, cs.T_GRID, rounds,
                                             out=buf), iters=10)
    k1_plain_ms = cuda_time_ms(
        lambda: cs.net_pass_plain(keys, cs.T_GRID, rounds), iters=1,
        warmup=1)
    k1_err = max_err(cs.net_pass(keys, cs.T_GRID, rounds, out=buf),
                     cs.net_pass_plain(keys, cs.T_GRID, rounds))
    # K2: the last round's most strided pass (bits [hi-G_MAX+1, hi])
    hi = 27 - log2t
    lo = hi - cs.G_MAX + 1
    k2_ms = cuda_time_ms(lambda: cs.cross_pass(keys, n, cs.T_GRID, lo, hi,
                                               False, out=buf), iters=10)
    k2_plain_ms = cuda_time_ms(
        lambda: cs.cross_pass_plain(keys, n, cs.T_GRID, lo, hi, False),
        iters=1, warmup=1)
    k2_err = max_err(cs.cross_pass(keys, n, cs.T_GRID, lo, hi, False,
                                   out=buf),
                     cs.cross_pass_plain(keys, n, cs.T_GRID, lo, hi, False))
    torch.cuda.synchronize()

    def bound(n_stages):
        t_bytes = 2 * n * 4 / bw * 1e3
        t_ops = 2 * (n // 2) * n_stages / VECTOR_OPS * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                             "operations")

    k1_bound, k1_by = bound(stages)
    k2_bound, k2_by = bound(hi - lo + 1)
    if k1_err != 0 or k2_err != 0:
        raise AssertionError(f"kernel error at main shapes: {k1_err} "
                             f"{k2_err}")
    emit({"phase": "timed_launches",
          "net_kernel": f"n=2^28 int32, tile 2^{log2t}, {stages} stages",
          "cross_kernel": f"n=2^28 int32, span 2^28, bits [{lo}, {hi}]",
          "seconds": round(time.perf_counter() - t_start, 1)})
    rows = [
        {"name": "net_kernel (K1)", "route": "cuda",
         "source": "icikit_torch/csrc/bitonic_net.cu",
         "replaces": "icikit/ops/pallas_sort.py:206",
         "launches": main_launches["net"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
        {"name": "cross_kernel (K2)", "route": "cuda",
         "source": "icikit_torch/csrc/bitonic_net.cu",
         "replaces": "icikit/ops/pallas_sort.py:267",
         "launches": main_launches["cross"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None},
    ]
    del keys, buf, x, oracle

    # -- 7. attention kernels against their plain versions -------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    attention_checks(torch, dev)

    # -- 8. the decode path: base, b = 8, prompt 512, 64 new -----------
    dec_launches = decode_path(torch, dev, bw, smi)

    # -- 9. per-kernel numbers at the decode path's shapes -------------
    rows += attention_rows(torch, dev, bw, dec_launches)

    # -- 10. train kernels against their plain versions ----------------
    train_kernel_checks(torch, dev)

    # -- 11. the train path: base, b = 8, s = 1024 ---------------------
    train_launches = train_path(torch, dev, smi)

    # -- 12. per-kernel numbers at the train path's shapes -------------
    rows += train_rows(torch, dev, bw, train_launches)
    emit({"phase": "done", "seconds": round(time.perf_counter() - t_start,
                                            1)})
    emit({"kernels": rows})
    print(smi)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
