#!/usr/bin/env python3
"""Drive icikit_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. device: the card's name and power limit (``nvidia-smi``).
2. build: the kernels from ``icikit_torch/csrc`` with ``nvcc`` (sm_90a),
   with each listed kernel's registers and local (spill) bytes a thread;
   the Adam and save-stack kernels must use no local memory.
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
   (1, 8, 128), s = 2048, in bf16 and float32, causal and not; at its
   tile edges (FWD_EDGES: s 65, 127, 129, 1000, 4097 at d 32, 64, 128,
   256, b 2, h 3), online and shift 16, causal and not;
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
   (the overflow the kernel redoes online), bf16 and float32; the redo
   where q x 400 lies only in the second warpgroup's rows or only in the
   ragged last Q tile (REDO_EDGES, d 64, 128, 256), its hot rows bitwise
   equal to the online pass's, their lse held relative to their largest
   |lse| and the other rows' absolute; the three
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
12. per-kernel numbers of the train path's kernels at its shapes.
13. the train step's other kernels held against their plain versions on
   the card: ``xent_g``, ``xent_g_saved``, ``xent_dx`` and ``xent_dw`` at
   T 8192, D 1024, V 32768 (XENT_TOL); the Adam kernel on the base
   preset's leaves with bf16 and float32 moments, ok absent, true and
   false, bit for bit; ``flash_bwd_dq``/``flash_bwd_dkv`` at (1, 8, 2048,
   128) and (1, 4, 8192, 128), causal and full, bf16 and float32, against
   ``flash_bwd_plain`` and against ``flash_bwd`` (FLASH_TOL of the largest
   entry, and BLOCK_L2_TOL relative L2 in every 64-row block).
14. the train arms: ``make_train_step`` of the ``base`` preset, b 8, s
   1024, bf16, with the recompute head (B10 recompute), the matmul head
   backward after the saved and the recompute forward (B11), and the
   one-pass Adam kernel (B12, float32 moments, as ``bench/train.py
   --optimizer fused-pallas``: one launch a step over the whole tree).
   Each arm's launches a step asserted; at b
   2 and float32 each arm held against the plain arms (dense attention,
   unfused head, PyTorch Adam) and the default arm: loss within 1e-4,
   every gradient leaf (the Adam arm: every parameter leaf after a step)
   within a relative L2 error of 1e-3; then step ms, tokens/s and mfu by
   phase 11's median-of-windows (one function runs every arm); the
   standalone Adam bench (``bench/adam.py``, 211 M parameters, bf16 and
   float32 gradients); and the kernels of this phase timed at the arms'
   shapes: the Adam kernel over the base tree at the step's gradient
   dtypes and at float32 gradients, each beside the bound of its own
   bytes, ``torch._fused_adam_`` at float32 gradients beside the second.
15. the long-context path: ``bench.attention.sweep_attention`` at s =
   32768 and 131072, b 1, h 4, d 128, bf16, causal, fwdbwd, impl
   ``flash``: one ``flash_bwd`` launch at 32768 and one of each two-pass
   kernel at 131072 asserted, each verified against the chunked plain
   oracle; TFLOP/s; the backward's dq, dk and dv at both lengths (``flash_bwd``
   at 32768, the two-pass kernels at 131072) held to the chunked plain
   versions within BLOCK_L2_TOL relative L2 in every 64-row block, and
   the two-pass outputs bitwise equal across two calls; then
   ``flash_bwd_dq`` and ``flash_bwd_dkv`` timed at (1, 4, 131072, 128)
   beside their chunked plain versions and SDPA's backward, each bounded
   by its share (3:4) of the function's five causal products;
   ``flash_fwd`` held to its chunked plain version at 131072 (out by
   BLOCK_L2_TOL in every 64-row block, lse by FLASH_TOL) and timed alone beside SDPA's causal forward and its bound (the two
   causal products, 17.8 ms); the bf16 flash kernels' registers, shared
   memory a CTA and CTAs an SM at every head dim.
16. the head dim 256: ``flash_fwd``, ``flash_bwd`` and the two-pass pair
   at d = 256 (WIDE_SHAPES) against their plain versions, bf16 and
   float32, with FLASH_TOL and BLOCK_L2_TOL; ``decode_step`` at dh 256
   and 384; ``greedy_generate`` of a d_head-256 MHA config (the base
   width, 4 heads, 2 layers), b 8, prompt 512, 16 new, its prefill
   ``flash_fwd`` and step launches asserted and its float32 tokens held
   to the plain arms; a float32 b 2 train step of that config against
   the plain arms (loss and gradients, flash launches asserted).
17. the int8 kernels against their plain versions: ``quant_matvec``
   (B15) at every (N, K) of the int8 path, rows 8 and 4096, x in bf16
   and float32 (QMV_TOL, relative to the largest entry);
   ``decode_step_q8`` (B14) at 64 rows, dh 128 and 256, 576 columns, cur
   0, 1, 300, 575 (Q8_STEP_TOL; the int8 cache columns bit for bit).
18. the int8 decode path: ``greedy_generate`` of the ``base`` preset with
   decode_quant="int8", decode_step="fused", quant_matvec="auto",
   attention "flash", bf16, b 8, prompt 512, 64 new, the weights
   quantized once outside the timing: 12 ``flash_fwd``, 756
   ``decode_step_q8`` and 3136 ``quant_matvec`` launches asserted, no
   ``decode_step``; the caches int8 with float32 scales; at float32 the
   tokens equal the plain arms' (decode_step "unfused", quant_matvec
   "xla", attention "dense") except after a near-tie
   (INT8_FP32_LOGIT_TOL); at bf16 the first step's logits within
   BF16_LOGIT_TOL; the int8-vs-bf16 token agreement as information;
   tokens/s by the chained median-of-windows beside the bf16 fused arm,
   prefill ms, the int8 byte-model bound and the idle share.
19. per-kernel numbers of B15 and B14 at the int8 path's shapes.
20. B17's kernels against their plain versions: ``tile_mxu`` and the
   four ``tile_ablate`` variants at (1, 2, 512, d), d = 64 and 128, bq =
   bk = 64, within TILE_TOL of the largest |plain| entry (both round w
   to bf16 at scores whose float32 sums differ in order).
21. the tile-floor path: ``bench.tile_floor.measure`` at s = 32768, h 8,
   d = 64 and 128, 3 windows: the six variants' per-tile us beside the
   per-tile bound (4 bq bk d operations at 989 TFLOP/s) and the render's
   decomposition (what exp2 and the running max cost inside
   ``flash_fwd``'s loop); ``tile_mxu``, ``tile_ablate`` and
   ``flash_fwd`` launched; then the five kernels against their plain
   versions at (1, 8, 32768, d), d = 64 and 128, within TILE_TOL, and
   at d = 64 timed, ``softmax_ks1`` beside non-causal
   ``scaled_dot_product_attention`` (the same function).
22. B16's kernels against their plain versions, bit for bit: every slice
   shape and dtype of the save-stack path's stacks at slices 0, 5, 11,
   and a slice off JAX's gate, which takes the plain copy and launches
   nothing.
23. the save-stack train path: ``make_train_step`` of the ``base`` preset,
   b 8, s 1024, bf16, phase 11's config with ``save_stack="pallas"``:
   84 ``stack_write``, 12 ``stack_read``, 24 ``flash_fwd``, 12
   ``flash_bwd`` and one launch of each cross-entropy kernel a step
   asserted (SAVE_STACK_LAUNCHES); at b 2 and float32 held against the
   default and the plain arms with phase 11's tolerances, the bf16
   first-step loss and the loss falling over 5 steps; step ms, tokens/s
   and mfu by phase 11's median-of-windows beside a second run of the
   default arm, and the idle share from a ``torch.profiler`` trace; then
   B16's kernels timed cold at the residual slice (the 12 slices of the
   stack in rotation, device time behind a sleep kernel) beside
   ``copy_`` timed the same way, their device time a launch in the
   step's trace, the host's time a call (the full per-call path, the
   layer loop's checked-once copier and ``copy_``) and the card's copy
   rate at 1 GiB.
24. kernels line: every ported kernel with its launches on its main path,
   its time at that path's shapes, its plain version's time, a library
   call's time where one computes the same function, and its bound.

The line before the last is ``nvidia-smi``'s name and power limit; the
last is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import ctypes
import itertools
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

# Phase 7: the forward's tile edges, lengths on and beside its 64- and
# 128-row (and key) tiles at every head dim built, at (b, h) = (2, 3)
FWD_EDGES = tuple((s, d) for s in (65, 127, 129, 1000, 4097)
                  for d in (32, 64, 128, 256))

# Train path (phases 10-12): the base preset at batch 8, s = 1024.
TRAIN_PRESET, TRAIN_BATCH, TRAIN_CHECK_BATCH = "base", 8, 2
TRAIN_TOKENS = TRAIN_BATCH * 1024
TRAIN_LR = 1e-4
SHIFT = 16.0
# (b, h, s, d) of the path's flash launches, and the many-block regime
FLASH_SHAPES = {"B5-shift": (TRAIN_BATCH, 8, 1024, 128),
                "B4": (1, 8, 2048, 128)}
# Phase 10: the shift's overflow redo at the forward's tile edges, (s,
# rows x 400): the second warpgroup's 64 rows of each 128-row CTA, and
# the ragged last Q tile
REDO_EDGES = ((256, ((64, 128), (192, 256))), (1000, ((960, 1000),)))
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
# The two-pass backward's check shapes, and the long-context path's
TWO_PASS_SHAPES = ((1, 8, 2048, 128), (1, 4, 8192, 128))
LONG_SEQS = (32768, 131072)
LONG_SHAPE = (1, 4, 128)                      # (b, h, d)
# Long-sequence gradients against their plain versions: relative L2 in
# each 64-row block (a kernel's tile), the largest over the blocks. dq
# and dk shrink along the rows, so an error relative to the largest
# entry would pass a kernel that got the later tiles wrong.
BLOCK_ROWS = 64
BLOCK_L2_TOL = {"bf16": 1e-2, "f32": 1e-4}
# The train arms (phases 11 and 14): config overrides, FusedAdam's
# use_pallas, and the kernels the arm launches once a step (the Adam
# kernel once, over the whole tree) beside flash_fwd, flash_bwd and
# xent_fwd
ARMS = {"default": ({}, False, ("xent_dx_saved", "xent_dw_saved")),
        "head-recompute": (dict(xent_save_exp=False), False,
                           ("xent_dx", "xent_dw")),
        "hb-matmul-saved": (dict(xent_fused_bwd=False), False,
                            ("xent_g_saved",)),
        "hb-matmul-recompute": (dict(xent_save_exp=False,
                                     xent_fused_bwd=False), False,
                                ("xent_g",)),
        "adam-kernel": ({}, True, ("xent_dx_saved", "xent_dw_saved",
                                   "adam"))}
# The save-stack arm (phase 23), an arm in ARMS' form run on its own
# path; a step at base: 12 layers, each writing its input and its six
# gradient slices (ln1, ln2, wqkv, wo, w1, w2, all on JAX's gate)
# through stack_write, reading its input back through stack_read and
# running its forward again in the backward
SAVE_STACK_ARM = (dict(save_stack="pallas"), False,
                  ("xent_dx_saved", "xent_dw_saved"))
SAVE_STACK_LAUNCHES = {"stack_write": 12 * 7, "stack_read": 12,
                       "flash_fwd": 24, "flash_bwd": 12}
# Phase 2: kernels that must use no local memory (registers only)
NO_LOCAL_MEMORY = ("adam_tree_kernel<f32 moments>",
                   "adam_tree_kernel<bf16 moments>", "stack_write_kernel",
                   "stack_read_kernel")
# Phases 20-21, B17: the check shapes (b, h, s) and the tile-floor path's
# (h, seq) at head dims 64 and 128; the check tolerance, relative to the
# largest |plain| entry
TILE_CHECK = (1, 2, 512)
TILE_PATH = (8, 32768)
TILE_DIMS = (64, 128)
TILE_TOL = 2e-2
# Phase 22, B16: the slice shapes and dtypes of the save-stack path's
# stacks (the residual, then the gradient leaves at grad_dtype="compute"),
# the slices checked, and a slice off JAX's gate (9 rows of bf16)
STACK_SLICES = {"residual": ((TRAIN_BATCH, 1024, 1024), "bfloat16"),
                "wqkv": ((1024, 3, 8, 128), "bfloat16"),
                "wo": ((8, 128, 1024), "bfloat16"),
                "w1": ((1024, 4096), "bfloat16"),
                "w2": ((4096, 1024), "bfloat16"),
                "ln1, ln2": ((1024,), "float32")}
STACK_CHECK_I = (0, 5, 11)
STACK_OFF_GATE = ((9, 128), "bfloat16")
# Phase 16: the flash kernels' d = 256 builds at (b, h, s, d), and a
# d_head-256 MHA config at the base width cut to two layers
WIDE_SHAPES = ((2, 4, 1024, 256), (1, 4, 2048, 256))
WIDE_CFG = dict(n_heads=4, d_head=256, n_layers=2)
WIDE_NEW = 16
TRAIN_SEQ_WIDE = 1024
# Phases 17-19, the int8 decode path: B15's (N, K) on it, its rows (the
# step's b and the prefill's b * s), the rows the kernels line reports,
# and the tolerances (relative to the largest |reference| entry for B15,
# absolute for B14's float32 output)
Q8_SHAPES = {"wqkv": (3072, 1024), "wo": (1024, 1024), "w1": (4096, 1024),
             "w2": (1024, 4096), "w_out": (32768, 1024)}
Q8_ROWS = (DEC_BATCH, DEC_BATCH * DEC_PROMPT)
Q8_ROW_ENTRIES = (("wqkv", DEC_BATCH), ("w_out", DEC_BATCH),
                  ("w1", DEC_BATCH * DEC_PROMPT))
QMV_TOL = {"bf16": 1e-4, "f32": 1e-5}
Q8_STEP_TOL = 1e-5
# int8 float32 tokens against the plain arms: a K/V element that sits
# within float32 rounding of an int8 rounding boundary lands on the
# neighbouring int8 value in one arm, which moves the logits by far more
# than float32 rounding does
INT8_FP32_LOGIT_TOL = 5e-2


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
        for s, d in FWD_EDGES:
            q, k, v = (randn((2, 3, s, d), dtype) for _ in range(3))
            for causal in (True, False):
                for shift in (None, SHIFT):
                    out, lse = ca.flash_fwd(q, k, v, causal, d ** -0.5,
                                            shift=shift)
                    want, want_lse = ca.flash_fwd_plain(
                        q, k, v, causal, d ** -0.5, shift=shift)
                    e_o, e_l = err(out, want), err(lse, want_lse)
                    checks.append({"kernel": "flash_fwd", "edge": True,
                                   "dtype": str(dtype),
                                   "shape": [2, 3, s, d], "causal": causal,
                                   "shift": shift, "out_err": e_o,
                                   "lse_err": e_l,
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
    want = {**dict.fromkeys(ca.LAUNCHES, 0), "flash_fwd": cfg.n_layers,
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


def _block_rel_l2(a, b) -> float:
    """The largest ||a - b|| / ||b|| over the BLOCK_ROWS-row blocks of
    (b, h, s, d) tensors, in float64."""
    a, b = (t.double().unflatten(2, (-1, BLOCK_ROWS)) for t in (a, b))
    num = (a - b).square().sum((-2, -1)).sqrt()
    den = b.square().sum((-2, -1)).sqrt().clamp_min(1e-300)
    return float((num / den).max())


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
    # the shift's redo where q x 400 lies only in the second warpgroup's
    # rows of each 128-row CTA, or only in the ragged last Q tile: the
    # hot rows carry the online pass's bits
    for dtype, tol in ((torch.bfloat16, FLASH_TOL["bf16"]),
                       (torch.float32, FLASH_TOL["f32"])):
        for s, hot in REDO_EDGES:
            for d in (64, 128, 256):
                q, k, v = (randn((1, 4, s, d), dtype) for _ in range(3))
                for a, b_ in hot:
                    q[:, :, a:b_] = (q[:, :, a:b_].float() * 400.0).to(dtype)
                out, lse = ca.flash_fwd(q, k, v, True, 0.125, shift=SHIFT)
                ref, ref_lse = ca.flash_fwd(q, k, v, True, 0.125)
                w_out, w_lse = ca.flash_fwd_plain(q, k, v, True, 0.125,
                                                  shift=SHIFT)
                rows = torch.cat([torch.arange(a, b_) for a, b_ in hot]
                                 ).to(dev)
                same = bool(torch.equal(out[:, :, rows], ref[:, :, rows])
                            and torch.equal(lse[:, :, rows],
                                            ref_lse[:, :, rows]))
                e_o = err(out, w_out)
                # the hot rows' lse relative to their largest |lse|, the
                # other rows' absolute
                is_hot = torch.zeros(s, dtype=torch.bool, device=dev)
                is_hot[rows] = True
                e_hot = (err(lse[:, :, is_hot], w_lse[:, :, is_hot])
                         / float(w_lse[:, :, is_hot].abs().max()))
                e_cold = err(lse[:, :, ~is_hot], w_lse[:, :, ~is_hot])
                finite = bool(torch.isfinite(lse).all()) and bool(
                    torch.isfinite(out.float()).all())
                checks.append({
                    "kernel": "flash_fwd shift redo", "dtype": str(dtype),
                    "shape": [1, 4, s, d], "hot_rows": hot,
                    "hot_rows_bitwise_online": same, "out_err": e_o,
                    "lse_err_hot_rows_rel": e_hot,
                    "lse_err_other_rows": e_cold, "finite": finite,
                    "ok": finite and same and e_o <= tol["out"]
                    and e_hot <= tol["lse"] and e_cold <= tol["lse"]})
                del q, k, v, out, lse, ref, ref_lse, w_out, w_lse
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
    return TransformerConfig(**{**PRESETS[TRAIN_PRESET],
                                "compute_dtype": dtype,
                                "remat_policy": "except_attn",
                                "softmax_shift": SHIFT, **over})


def train_cell(torch, dev) -> dict:
    """The train cell of phases 11 and 14: the base preset's masters (a
    seeded generator), the b = 8 data (``numpy.random.default_rng(0)``)
    and, at b = 2 and float32, the loss and gradients of the plain arms
    (dense attention, unfused head) and of the default arm."""
    import numpy as np

    from icikit_torch.bench.train import detect_peak, step_flops
    from icikit_torch.models.transformer import (init_params,
                                                 loss_and_metrics,
                                                 make_model_mesh)

    mesh = make_model_mesh(device=dev)
    cfg = _train_config("bfloat16")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    rng = np.random.default_rng(0)
    tok, tgt = (torch.from_numpy(rng.integers(0, cfg.vocab,
                                              (TRAIN_BATCH, cfg.max_seq))
                                 .astype(np.int32)).to(dev)
                for _ in range(2))
    b2 = (tok[:TRAIN_CHECK_BATCH], tgt[:TRAIN_CHECK_BATCH])
    plain_cfg = _train_config("float32", attention_impl="dense",
                              fused_head=False)
    loss_p, g_p, _ = loss_and_metrics(params, *b2, mesh, plain_cfg)
    loss_d, g_d, _ = loss_and_metrics(params, *b2, mesh,
                                      _train_config("float32"))
    return {"mesh": mesh, "params": params, "tok": tok, "tgt": tgt,
            "b2": b2, "seq": cfg.max_seq, "plain_cfg": plain_cfg,
            "plain": (float(loss_p), g_p), "default": (float(loss_d), g_d),
            "flops": step_flops(cfg, TRAIN_BATCH, cfg.max_seq),
            "peak": detect_peak(dev)}


def train_arm(torch, cell, arm, spec, smi=None, phase="train") -> dict:
    """One arm of the train cell, ``spec`` in ``ARMS``' form: at b = 2
    and float32 held against the plain arms and the default arm (the Adam
    kernel's arm by its parameters after one step); the b = 8 bf16 step
    with its launches counted on the second step; step ms, tokens/s and
    mfu by median-of-windows. With ``smi`` (the main paths of phases 11
    and 23) also the bf16 first-step loss, the loss falling over 5 steps,
    a profiler trace and the lines ``{phase}_check`` and
    ``{phase}_timing``. Returns the arm's record, ``ok`` in it."""
    import numpy as np

    from icikit_torch.models.transformer import (FusedAdam,
                                                 loss_and_metrics,
                                                 make_train_step)
    from icikit_torch.ops import cuda_adam, cuda_stack
    from icikit_torch.ops import cuda_attention as ca
    from icikit_torch.ops import cuda_xent as cx
    from icikit_torch.utils.timing import timeit_windows
    from icikit_torch.utils.trace import device_activity

    t0 = time.perf_counter()
    over, pallas, kernels = spec
    mesh, params, b2 = cell["mesh"], cell["params"], cell["b2"]
    tok, tgt, seq = cell["tok"], cell["tgt"], cell["seq"]
    (loss_p, g_p), (loss_d, g_d) = cell["plain"], cell["default"]
    flops, peak = cell["flops"], cell["peak"]

    # float32, b = 2: against the plain arms and the default arm
    if pallas:
        def one_step(cfg, adam):
            p = {k: x.clone() for k, x in params.items()}
            opt, step = make_train_step(mesh, cfg, adam)
            p, _, loss = step(p, opt.init(p), *b2)
            return p, float(loss)

        got, loss_k = one_step(_train_config("float32"),
                               FusedAdam(TRAIN_LR, use_pallas=True))
        ref_p = one_step(cell["plain_cfg"], FusedAdam(TRAIN_LR))[0]
        ref_d = one_step(_train_config("float32"), FusedAdam(TRAIN_LR))[0]
        what = "parameter leaves after one step"
    else:
        got, ref_p, ref_d, what = g_d, g_p, g_d, "gradient leaves"
        loss_k = loss_d
        if over:
            loss_k, got, _ = loss_and_metrics(
                params, *b2, mesh, _train_config("float32", **over))
            loss_k = float(loss_k)
    leaf_p = {k: _rel_l2(got[k], ref_p[k]) for k in ref_p}
    err_d = max(_rel_l2(got[k], ref_d[k]) for k in ref_d)
    fp32 = {"loss": loss_k, "loss_plain": loss_p, "loss_default_arm": loss_d,
            "loss_diff_plain": abs(loss_k - loss_p),
            "loss_diff_default": abs(loss_k - loss_d),
            "rel_l2_max_plain": max(leaf_p.values()),
            "rel_l2_max_default": err_d, "compared": what}
    del got, ref_p, ref_d
    ok = (fp32["loss_diff_plain"] <= TRAIN_LOSS_TOL
          and fp32["loss_diff_default"] <= TRAIN_LOSS_TOL
          and fp32["rel_l2_max_plain"] <= TRAIN_GRAD_TOL
          and err_d <= TRAIN_GRAD_TOL)

    # b = 8, bf16, the second step counted
    cfg = _train_config("bfloat16", **over)
    adam = (FusedAdam(TRAIN_LR, use_pallas=True) if pallas else
            FusedAdam(TRAIN_LR, mu_dtype=torch.bfloat16,
                      nu_dtype=torch.bfloat16))
    p = {k: x.clone() for k, x in params.items()}
    opt, step = make_train_step(mesh, cfg, adam)
    st = opt.init(p)
    p, st, loss = step(p, st, tok, tgt)           # first-call set-up
    losses = [float(loss)]
    mods = (ca, cx, cuda_adam, cuda_stack)
    for mod in mods:
        mod.reset_launches()
    p, st, loss = step(p, st, tok, tgt)
    torch.cuda.synchronize()
    launches = {k: n for mod in mods for k, n in mod.LAUNCHES.items()}
    losses.append(float(loss))
    want = {**dict.fromkeys(launches, 0), "flash_fwd": cfg.n_layers,
            "flash_bwd": cfg.n_layers, "xent_fwd": 1,
            **dict.fromkeys(kernels, 1)}
    if cfg.save_stack == "pallas":
        want.update(SAVE_STACK_LAUNCHES)
    ok = ok and launches == want
    if smi is not None:
        for _ in range(3):
            p, st, loss = step(p, st, tok, tgt)
            losses.append(float(loss))
        loss_b = float(loss_and_metrics(params, *b2, mesh, cfg)[0])
        bf16_first = {"loss": loss_b,
                      "rel_diff_to_fp32_plain": abs(loss_b - loss_p) / loss_p,
                      "tolerance": TRAIN_BF16_TOL}
        ok = (ok and bf16_first["rel_diff_to_fp32_plain"] <= TRAIN_BF16_TOL
              and losses[-1] < losses[0])
        emit({"phase": f"{phase}_check", "preset": TRAIN_PRESET,
              "arm": arm,
              "batch": TRAIN_BATCH, "seq": seq,
              "check_batch": TRAIN_CHECK_BATCH, "launches_per_step": launches,
              "fp32": {"loss_kernels": loss_k, "loss_plain": loss_p,
                       "loss_diff": fp32["loss_diff_plain"],
                       "loss_tolerance": TRAIN_LOSS_TOL,
                       "grad_rel_l2_max": fp32["rel_l2_max_plain"],
                       "grad_rel_l2": leaf_p,
                       "grad_tolerance": TRAIN_GRAD_TOL},
              "bf16_first_step": bf16_first, "bf16_losses_5_steps": losses,
              "seconds": round(time.perf_counter() - t0, 1)})
    ok = ok and bool(np.isfinite(losses).all())

    # timing: chained steps carried in place, median of windows of at
    # least 1.5 s (a step is ~0.1 s, and host noise spreads short
    # windows); at most 5 windows, so the five arms fit the time limit
    n_steps = 5

    def multi(p, s):
        out = (p, s, None)
        for _ in range(n_steps):
            out = step(out[0], out[1], tok, tgt)
        return out

    res = timeit_windows(multi, (p, st), lambda a, o: (o[0], o[1]),
                         windows=3, runs=1, warmup=1, target_window_s=1.5,
                         max_windows=5,
                         floor_s=n_steps * flops / peak if peak else None)
    step_s = res.median_s / n_steps
    rec = {"fp32_b2": fp32, "launches_per_step": launches, "want": want,
           "bf16_losses": losses, "step_ms": step_s * 1e3,
           "step_ms_spread": [res.min_s / n_steps * 1e3,
                              res.max_s / n_steps * 1e3],
           "windows": res.windows, "suspect": res.suspect,
           "tokens_per_s": TRAIN_BATCH * seq / step_s,
           "mfu": flops / step_s / peak if peak else None, "ok": ok}
    if smi is not None:
        rec["profile"] = device_activity(lambda: step(p, st, tok, tgt))
        emit({"phase": f"{phase}_timing", "card": smi, "arm": arm,
              **{k: rec[k] for k in ("step_ms", "step_ms_spread", "windows",
                                     "suspect", "tokens_per_s")},
              "model_tflops_per_s": flops / step_s / 1e12, "mfu": rec["mfu"],
              "step_flops": flops, "peak_flops": peak,
              "bound_ms": flops / BF16_TENSOR_OPS * 1e3,
              "profile": rec["profile"],
              "seconds": round(time.perf_counter() - t0, 1)})
    del p, st, opt, step
    torch.cuda.empty_cache()
    return rec


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


def _base_tree_grads(torch, params, gen, cdt):
    """Random gradients shaped as the train step gives them: the matmul
    weights' in the compute dtype, the rest float32."""
    from icikit_torch.models.transformer.model import NARROW_OK
    return {k: torch.randn(p.shape, generator=gen, device=p.device)
            .to(cdt if k in NARROW_OK else torch.float32)
            for k, p in params.items()}


def train_arm_kernel_checks(torch, dev) -> None:
    """Phase 13: the recompute and matmul head kernels, the Adam kernel
    and the two-pass backward against their plain versions on the card."""
    from icikit_torch.bench.train import PRESETS
    from icikit_torch.models.transformer import (TransformerConfig,
                                                 init_params)
    from icikit_torch.ops import cuda_attention as ca
    from icikit_torch.ops import cuda_xent as cx
    from icikit_torch.ops.adam import adam_apply

    gen = torch.Generator(device=dev).manual_seed(6)

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    checks = []
    t, d, v = XENT_SHAPE
    for dtype, tol in ((torch.bfloat16, XENT_TOL["bf16"]),
                       (torch.float32, XENT_TOL["f32"])):
        x = randn((t, d), dtype)
        w = randn((v, d), dtype, d ** -0.5)
        tg = torch.randint(0, v, (t,), generator=gen, device=dev,
                           dtype=torch.int32)
        dn = randn((t,), torch.float32, 1.0 / t)
        lse, _, e, mrun = cx.xent_fwd(x, w, tg, save=True)
        errs = {"xent_g": _rel(cx.xent_g(x, w, tg, lse, dn),
                               cx.xent_g_plain(x, w, tg, lse, dn)),
                "xent_g_saved": _rel(
                    cx.xent_g_saved(e, mrun, tg, lse, dn),
                    cx.xent_g_saved_plain(e, mrun, tg, lse, dn,
                                          cx.TILE[dtype])),
                "xent_dx": _rel(cx.xent_dx(x, w, tg, lse, dn),
                                cx.xent_dx_plain(x, w, tg, lse, dn)),
                "xent_dw": _rel(cx.xent_dw(x, w, tg, lse, dn),
                                cx.xent_dw_plain(x, w, tg, lse, dn))}
        checks.append({"kernel": "xent_g, xent_g_saved, xent_dx, xent_dw",
                       "dtype": str(dtype), "shape": [t, d, v],
                       "rel_err": errs,
                       "ok": max(errs.values()) <= tol["grad"]})
        del x, w, e, mrun
        torch.cuda.empty_cache()

    cfg = TransformerConfig(**PRESETS[TRAIN_PRESET])
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    grads = _base_tree_grads(torch, params, gen, torch.bfloat16)
    for mom in (torch.bfloat16, torch.float32):
        m0 = {k: randn(p.shape, mom, 0.01) for k, p in params.items()}
        v0 = {k: randn(p.shape, torch.float32, 0.01).square().to(mom)
              for k, p in params.items()}
        for ok in (None, True, False):
            flag = None if ok is None else torch.tensor(ok, device=dev)
            runs = []
            for pallas in (True, False):
                p1 = {k: x.clone() for k, x in params.items()}
                m1 = {k: x.clone() for k, x in m0.items()}
                v1 = {k: x.clone() for k, x in v0.items()}
                adam_apply(p1, m1, v1, grads, TRAIN_LR, 3,
                           use_pallas=pallas, ok=flag)
                runs.append((p1, m1, v1))
            same = all(torch.equal(a[k], b[k]) for a, b in
                       zip(runs[0], runs[1]) for k in params)
            checks.append({"kernel": "adam", "moments": str(mom),
                           "ok_flag": ok, "leaves": len(params),
                           "bitwise": same, "ok": same})
            del runs
    del params, grads, m0, v0
    torch.cuda.empty_cache()

    for dtype, key in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        tol, l2_tol = FLASH_TOL[key]["grad"], BLOCK_L2_TOL[key]
        for b, h, s_, d_ in TWO_PASS_SHAPES:
            q, k, v_, do = (randn((b, h, s_, d_), dtype) for _ in range(4))
            scale = d_ ** -0.5
            for causal in (True, False):
                out, lse = ca.flash_fwd(q, k, v_, causal, scale)
                delta = (do.float() * out.float()).sum(-1)
                args = (q, k, v_, do, lse, delta, causal, scale)
                got = (ca.flash_bwd_dq(*args), *ca.flash_bwd_dkv(*args))
                e, l2 = {}, {}
                for ref, want in (("plain", ca.flash_bwd_plain(*args)),
                                  ("flash_bwd", ca.flash_bwd(*args))):
                    e[ref] = max(_rel(a, c) for a, c in zip(got, want))
                    l2[ref] = max(_block_rel_l2(a, c)
                                  for a, c in zip(got, want))
                again = torch.equal(got[0], ca.flash_bwd_dq(*args))
                checks.append({
                    "kernel": "flash_bwd_dq + flash_bwd_dkv",
                    "dtype": str(dtype), "shape": [b, h, s_, d_],
                    "causal": causal, "rel_err": e, "block_rel_l2": l2,
                    "dq_repeatable": again,
                    "ok": max(e.values()) <= tol
                    and max(l2.values()) <= l2_tol and again})
            del q, k, v_, do, out, lse, delta, got
    torch.cuda.synchronize()
    emit({"phase": "train_arm_kernels",
          "tolerance": {"xent": XENT_TOL, "flash": FLASH_TOL,
                        "flash_block_rel_l2": BLOCK_L2_TOL,
                        "block_rows": BLOCK_ROWS,
                        "adam": "bit for bit",
                        "why": "xent: the logits summed in other orders, "
                               "g rounded to bf16 for the tensor cores "
                               "against the plain version's float32; the "
                               "two-pass backward as flash_bwd's, and in "
                               "each 64-row block by relative L2; Adam: "
                               "the same float32 operations, each "
                               "rounded once, in the same order; "
                               "rel_err relative to the largest entry"},
          "checks": checks})
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise AssertionError(f"train-arm kernel disagrees with its plain "
                             f"version: {bad}")


def train_arms(torch, dev, bw, smi, cell) -> list:
    """Phase 14: the base train step through each of the other arms;
    returns the rows of the kernels these arms launch."""
    from icikit_torch.bench.adam import run_bench as adam_bench
    from icikit_torch.bench.stream_ab import adam_bytes, device_ms
    from icikit_torch.ops import cuda_adam
    from icikit_torch.ops import cuda_xent as cx
    from icikit_torch.ops.adam import adam_scalars
    from icikit_torch.utils.timing import cuda_time_ms

    t0 = time.perf_counter()
    results = {arm: train_arm(torch, cell, arm, spec)
               for arm, spec in ARMS.items() if arm != "default"}
    emit({"phase": "train_arms", "card": smi, "preset": TRAIN_PRESET,
          "batch": TRAIN_BATCH, "seq": cell["seq"],
          "check_batch": TRAIN_CHECK_BATCH,
          "tolerance": {"loss": TRAIN_LOSS_TOL, "rel_l2": TRAIN_GRAD_TOL},
          "arms": results, "seconds": round(time.perf_counter() - t0, 1)})
    if not all(r["ok"] for r in results.values()):
        raise AssertionError(f"a train arm failed: {results}")

    # the standalone Adam bench: 211 M parameters, float32 moments, bf16
    # and float32 gradients (the library's yardstick takes float32)
    recs = [r for gdt in ("bfloat16", "float32")
            for r in adam_bench(211.0, runs=2, grad_dtype=gdt, device=dev,
                                windows=3)]
    emit({"phase": "adam_bench", "card": smi, "records": recs})

    # the kernels of this phase at the arms' shapes
    gen = torch.Generator(device=dev).manual_seed(7)
    bf = torch.bfloat16

    def bound(nbytes, ops):
        t_b, t_o = nbytes / bw, ops / BF16_TENSOR_OPS
        return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"

    t, d, v = XENT_SHAPE
    x = torch.randn((t, d), generator=gen, device=dev).to(bf)
    w = (torch.randn((v, d), generator=gen, device=dev) * d ** -0.5).to(bf)
    tg = torch.randint(0, v, (t,), generator=gen, device=dev,
                       dtype=torch.int32)
    dn = torch.full((t,), 1.0 / t, device=dev)
    lse, _, e, mrun = cx.xent_fwd(x, w, tg, save=True)
    chunk = cx.TILE[bf]
    nc = -(-v // chunk)
    ops = 2 * t * v * d
    rows_io = 3 * t * 4
    kernel_rows = []
    specs = (
        ("xent_dx", "xent_dx (B10 recompute)", "icikit/ops/xent.py:374 "
         "(B10, _dx_kernel, e_ref=None)", "head-recompute",
         lambda: cx.xent_dx(x, w, tg, lse, dn),
         lambda: cx.xent_dx_plain(x, w, tg, lse, dn),
         bound((t * d + v * d + t * d) * 2 + rows_io, 2 * ops)),
        ("xent_dw", "xent_dw (B10 recompute)", "icikit/ops/xent.py:411 "
         "(B10, _dw_kernel, e_ref=None)", "head-recompute",
         lambda: cx.xent_dw(x, w, tg, lse, dn),
         lambda: cx.xent_dw_plain(x, w, tg, lse, dn),
         bound((t * d + v * d + v * d) * 2 + rows_io, 2 * ops)),
        ("xent_g", "xent_g (B11 recompute)", "icikit/ops/xent.py:312 "
         "(B11, _bwd_kernel)", "hb-matmul-recompute",
         lambda: cx.xent_g(x, w, tg, lse, dn),
         lambda: cx.xent_g_plain(x, w, tg, lse, dn),
         bound((t * d + v * d + t * v) * 2 + rows_io, ops)),
        ("xent_g_saved", "xent_g_saved (B11 saved)", "icikit/ops/xent.py:335 "
         "(B11, _g_saved_kernel)", "hb-matmul-saved",
         lambda: cx.xent_g_saved(e, mrun, tg, lse, dn),
         lambda: cx.xent_g_saved_plain(e, mrun, tg, lse, dn, chunk),
         bound(2 * t * v * 2 + nc * t * 4 + rows_io, 0)))
    for key, name, replaces, arm, kern, plain, (b_ms, b_by) in specs:
        k_ms = cuda_time_ms(kern, iters=5, warmup=1)
        p_ms = cuda_time_ms(plain, iters=2, warmup=1)
        kernel_rows.append({
            "name": name, "route": "cuda",
            "source": "icikit_torch/csrc/xent.cu", "replaces": replaces,
            "launches": results[arm]["launches_per_step"][key],
            "max_abs_err": _rel(kern(), plain()), "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None})
    mm_ms = cuda_time_ms(lambda: torch.matmul(x, w.t()), iters=5)
    del x, w, e, mrun
    torch.cuda.empty_cache()

    # Adam over the base tree as the fused-pallas arm runs it: the tree
    # kernel at the step's gradient dtypes and at float32 gradients, the
    # library's fused Adam at float32 gradients (the same bytes as the
    # second), each beside the bound of its own bytes; device time by
    # CUDA events over calls queued behind a sleep kernel
    keys = list(cell["params"])
    tree = [cell["params"][k].clone() for k in keys]
    g_step = _base_tree_grads(torch, cell["params"], gen, bf)
    g_step = [g_step[k] for k in keys]
    g32 = [g.float() for g in g_step]
    mom = [[torch.zeros_like(x) for x in tree] for _ in range(2)]
    sc = adam_scalars(TRAIN_LR, torch.tensor(1, device=dev))
    a_launches = results["adam-kernel"]["launches_per_step"]["adam"]
    steps = [torch.ones((), device=dev) for _ in tree]
    a_lib = device_ms(lambda: torch._fused_adam_(
        tree, g32, *mom, [], steps, amsgrad=False, lr=TRAIN_LR, beta1=0.9,
        beta2=0.999, weight_decay=0.0, eps=1e-8, maximize=False), 10, 500.0)
    adam_info = {}
    for tag, gs in (("the step's gradients", g_step),
                    ("float32 gradients", g32)):
        a_ms = device_ms(lambda: cuda_adam.adam_tree(
            tree, *mom, gs, sc, 0.9, 0.999, 1e-8), 10, 500.0)
        a_plain = device_ms(lambda: cuda_adam.adam_tree_plain(
            tree, *mom, gs, sc, 0.9, 0.999, 1e-8), 3, 5000.0)
        runs = []
        for kern in (cuda_adam.adam_tree, cuda_adam.adam_tree_plain):
            st = [[x.clone() for x in t] for t in (tree, *mom)]
            kern(*st, gs, sc, 0.9, 0.999, 1e-8)
            runs.append(st)
        a_err = max(float((a - b).abs().max()) for x, y in zip(*runs)
                    for a, b in zip(x, y))
        del runs
        a_bytes = adam_bytes(tree, gs)
        adam_info[tag] = {"bytes": a_bytes, "ms": a_ms,
                          "tb_per_s": a_bytes / (a_ms * 1e-3) / 1e12}
        kernel_rows.append({
            "name": f"adam (B12), base tree, {tag}", "route": "cuda",
            "source": "icikit_torch/csrc/adam.cu",
            "replaces": "icikit/ops/adam.py:71 (B12, _adam_kernel)",
            "launches": a_launches, "max_abs_err": a_err, "ms": a_ms,
            "plain_ms": a_plain, "bound_ms": a_bytes / bw * 1e3,
            "bound_by": "bytes",
            "library_ms": a_lib if tag == "float32 gradients" else None})
    torch.cuda.synchronize()
    emit({"phase": "train_arm_timing_kernels",
          "xent": f"T={t} D={d} V={v} bf16", "matmul_x_wT_ms": mm_ms,
          "xent_library": "none: no one PyTorch call forms g or dx/dw "
                          "from recomputed logits; torch.matmul of x w^T "
                          "alone (cuBLAS) beside it",
          "adam": f"the base tree, {len(tree)} leaves, float32 moments, "
                  "at the step's gradient dtypes (matmul weights bf16) "
                  "and at float32 gradients; ms for the whole tree, one "
                  "launch, device time behind a sleep kernel",
          "adam_rows": adam_info, "adam_library_ms": a_lib,
          "adam_library": "torch._fused_adam_ over the same tree with "
                          "float32 gradients (28 B an element, the bytes "
                          "of the float32-gradient row), a yardstick: "
                          "torch's Adam without weight decay is optax's "
                          "with eps_root = 0",
          "max_abs_err": "xent rows relative to the largest entry; adam "
                         "absolute, p, m and v after one update"})
    del tree, g_step, g32, mom
    torch.cuda.empty_cache()
    return kernel_rows


def flash_occupancy() -> dict:
    """The bf16 flash kernels at every head dim: registers and local
    bytes a thread, dynamic shared memory a CTA and CTAs an SM."""
    from icikit_torch.ops import _build
    lib = _build.load("attention")
    # indices into icikit_attention_regs: flash_bwd, flash_bwd_dq,
    # flash_bwd_dkv, flash_fwd (icikit_flash_occupancy's order)
    regs_at = {32: (18, 20, 22, 24), 64: (19, 21, 23, 25),
               128: (3, 5, 7, 0), 256: (10, 12, 14, 8)}
    occ = {}
    for d, idx in regs_at.items():
        for which, (name, ri) in enumerate(zip(
                ("flash_bwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_fwd"),
                idx)):
            r, loc, smem, ctas = (ctypes.c_int() for _ in range(4))
            _build.check(lib.icikit_attention_regs(
                ri, ctypes.byref(r), ctypes.byref(loc)), "kernel attributes")
            _build.check(lib.icikit_flash_occupancy(
                which, d, ctypes.byref(smem), ctypes.byref(ctas)),
                "occupancy")
            occ[f"{name} d{d}"] = {
                "registers": r.value, "local_bytes": loc.value,
                "smem_bytes": smem.value, "ctas_per_sm": ctas.value}
    return occ


def long_context(torch, dev, bw, smi) -> list:
    """Phase 15: the long-context attention bench through flash (B7 at
    32768, the two-pass B8 at 131072); returns the B8 rows."""
    import torch.nn.functional as F

    from icikit_torch.bench.attention import ORACLE_CHUNK, sweep_attention
    from icikit_torch.ops import cuda_attention as ca
    from icikit_torch.utils.timing import cuda_time_ms

    t0 = time.perf_counter()
    b, h, d = LONG_SHAPE
    # one fwdbwd call's launches (each record's verification call), and
    # the kernels the whole sweep point launched, timing runs included
    want = {LONG_SEQS[0]: {"flash_fwd": 1, "flash_bwd": 1},
            LONG_SEQS[1]: {"flash_fwd": 1, "flash_bwd_dq": 1,
                           "flash_bwd_dkv": 1}}
    recs, totals = [], {}
    for seq in LONG_SEQS:
        ca.reset_launches()
        recs += sweep_attention((seq,), impls=["flash"], batch=b, heads=h,
                                d_head=d, dtype="bfloat16", causal=True,
                                mode="fwdbwd", runs=1, warmup=1, device=dev,
                                windows=2)
        torch.cuda.synchronize()
        totals[seq] = {k: n for k, n in ca.LAUNCHES.items() if n}
    emit({"phase": "long_context", "card": smi,
          "command": "sweep_attention((32768, 131072), impls=['flash'], "
                     "batch=1, heads=4, d_head=128, mode='fwdbwd')",
          "records": [json.loads(r.to_json()) for r in recs],
          "sweep_launches": totals,
          "seconds": round(time.perf_counter() - t0, 1)})
    bad = [r for r in recs if not r.verified or r.launches != want[r.seq]]
    bad += [(seq, got) for seq, got in totals.items()
            if set(got) != set(want[seq])]
    if bad:
        raise AssertionError(f"long-context path failed: {bad}")

    # the backward's gradients at each length against the chunked plain
    # versions, block by block (flash_bwd at 32768, the two-pass kernels
    # at 131072), and the two-pass kernels timed at 131072
    gen = torch.Generator(device=dev).manual_seed(8)
    scale = d ** -0.5
    checks = []
    for s in LONG_SEQS:
        q, k, v, do = (torch.randn((b, h, s, d), generator=gen, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        out, lse = ca.flash_fwd(q, k, v, True, scale)
        delta = (do.float() * out.float()).sum(-1)
        two = s == LONG_SEQS[1]
        if two:  # the forward against its chunked plain version
            w_out, w_lse = ca.flash_fwd_plain(q, k, v, True, scale,
                                              chunk=ORACLE_CHUNK)
            # out shrinks along the rows as the gradients do: held by
            # block, its error relative to the largest entry only shown
            fwd_err = {"out_block_rel_l2": _block_rel_l2(out, w_out),
                       "out_rel": _rel(out, w_out),
                       "lse": float((lse - w_lse).abs().max())}
            del w_out, w_lse
        del out
        args = (q, k, v, do, lse, delta, True, scale)
        got = ((ca.flash_bwd_dq(*args), *ca.flash_bwd_dkv(*args)) if two
               else ca.flash_bwd(*args))
        names = ("dq", "dk", "dv")
        # the two-pass kernels write every output once: a second call
        # gives the same bits
        same = ({n: torch.equal(a, c) for n, a, c in zip(
            names, got, (ca.flash_bwd_dq(*args), *ca.flash_bwd_dkv(*args)))}
            if two else {})
        want_ = ca.flash_bwd_plain(*args, chunk=ORACLE_CHUNK)
        rel = {n: _rel(a, c) for n, a, c in zip(names, got, want_)}
        l2 = {n: _block_rel_l2(a, c) for n, a, c in zip(names, got, want_)}
        checks.append({"seq": s, "kernels": ("flash_bwd_dq + flash_bwd_dkv"
                                             if two else "flash_bwd"),
                       "block_rel_l2": l2, "rel_err": rel,
                       **({"repeat_bitwise": same} if two else {}),
                       "ok": (max(l2.values()) <= BLOCK_L2_TOL["bf16"]
                              and all(same.values()))})
        del got, want_
        if not two:
            del q, k, v, do, lse, delta
            torch.cuda.empty_cache()
    pairs = b * h * s * (s + 1) // 2
    prod = 2 * d * pairs                      # one causal product
    io = 4 * b * h * s * d * 2 + 2 * b * h * s * 4
    rows = []
    # the function's five causal products, shared 3:4 as the kernels run
    # three (dq) and four (dk, dv) of the seven
    for name, kern, plain, n_prod, out_bytes, errs in (
            ("flash_bwd_dq", ca.flash_bwd_dq, ca.flash_bwd_dq_plain, 3,
             b * h * s * d * 2, ("dq",)),
            ("flash_bwd_dkv", ca.flash_bwd_dkv, ca.flash_bwd_dkv_plain, 4,
             2 * b * h * s * d * 2, ("dk", "dv"))):
        k_ms = cuda_time_ms(lambda: kern(*args), iters=3, warmup=1)
        p_ms = cuda_time_ms(lambda: plain(*args, chunk=ORACLE_CHUNK),
                            iters=1, warmup=0)
        t_b = (io + out_bytes) / bw
        t_o = 5 * n_prod / 7 * prod / BF16_TENSOR_OPS
        rows.append({"name": f"{name} (B8)", "route": "cuda",
                     "source": "icikit_torch/csrc/attention.cu",
                     "replaces": ("icikit/ops/flash_attention.py:745 (B8, "
                                  "_bwd_dq_kernel)" if name.endswith("dq")
                                  else "icikit/ops/flash_attention.py:771 "
                                       "(B8, _bwd_dkv_kernel)"),
                     "launches": recs[1].launches[name],
                     "max_abs_err": max(checks[1]["rel_err"][n]
                                        for n in errs),
                     "ms": k_ms, "plain_ms": p_ms,
                     "bound_ms": max(t_b, t_o) * 1e3,
                     "bound_by": "bytes" if t_b >= t_o else "operations"})
    lq, lk, lv = (t_.detach().clone().requires_grad_(True)
                  for t_ in (q, k, v))
    lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True,
                                        scale=scale)
    lib_ms = cuda_time_ms(lambda: torch.autograd.grad(
        lo, (lq, lk, lv), do, retain_graph=True), iters=3, warmup=1)
    for r in rows:
        r["library_ms"] = lib_ms
    # the forward alone, beside SDPA's causal forward and its bound (the
    # two causal products)
    f_ms = cuda_time_ms(lambda: ca.flash_fwd(q, k, v, True, scale),
                        iters=3, warmup=1)
    f_plain = cuda_time_ms(lambda: ca.flash_fwd_plain(
        q, k, v, True, scale, chunk=ORACLE_CHUNK), iters=1, warmup=0)
    f_lib = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=scale), iters=3, warmup=1)
    t_b = (4 * b * h * s * d * 2 + b * h * s * 4) / bw
    t_o = 2 * prod / BF16_TENSOR_OPS
    fwd_ok = (fwd_err["out_block_rel_l2"] <= BLOCK_L2_TOL["bf16"]
              and fwd_err["lse"] <= FLASH_TOL["bf16"]["lse"])
    rows.append({"name": "flash_fwd (B3, long context)", "route": "cuda",
                 "source": "icikit_torch/csrc/attention.cu",
                 "replaces": "icikit/ops/flash_attention.py:421 (B3, "
                             "_fwd_kernel)",
                 "launches": recs[1].launches["flash_fwd"],
                 "max_abs_err": fwd_err["out_rel"], "ms": f_ms,
                 "plain_ms": f_plain, "bound_ms": max(t_b, t_o) * 1e3,
                 "bound_by": "bytes" if t_b >= t_o else "operations",
                 "library_ms": f_lib})
    torch.cuda.synchronize()
    emit({"phase": "long_context_kernels", "card": smi,
          "shape": f"b={b} h={h} s={s} d={d} bf16 causal",
          "flash_fwd": {"ms": f_ms, "sdpa_forward_ms": f_lib,
                        "bound_ms": max(t_b, t_o) * 1e3,
                        "err_vs_chunked_plain": fwd_err,
                        "tolerance": {
                            "out_block_rel_l2": BLOCK_L2_TOL["bf16"],
                            "lse": FLASH_TOL["bf16"]["lse"]},
                        "ok": fwd_ok},
          "checks": checks,
          "occupancy": flash_occupancy(),
          "tolerance": {"block_rel_l2": BLOCK_L2_TOL["bf16"],
                        "block_rows": BLOCK_ROWS},
          "library": "SDPA's backward (dq, dk and dv together) through "
                     "autograd on the same tensors, beside each of the two "
                     "kernels",
          "bound": "the function's five causal products "
                   f"({5 * prod / BF16_TENSOR_OPS * 1e3:.2f} ms) shared "
                   "3:4 between the kernels, which run seven",
          "ms_sum": rows[0]["ms"] + rows[1]["ms"],
          "plain": f"the chunked plain versions, {ORACLE_CHUNK} Q rows a "
                   "step",
          "max_abs_err": "relative to the largest entry"})
    del q, k, v, do, lse, delta, lq, lk, lv, lo
    torch.cuda.empty_cache()
    bad = [c for c in checks if not c["ok"]]
    if bad or not fwd_ok:
        raise AssertionError(f"long-context forward or gradients disagree "
                             f"with the chunked plain versions: {bad}, "
                             f"forward {fwd_err}")
    return rows


def wide_head_checks(torch, dev, smi) -> None:
    """Phase 16: the flash kernels at d = 256 and the fused step at dh 256
    and 384 against their plain versions; a d_head-256 generate and a
    float32 train step of that config against the plain arms."""
    import dataclasses

    from icikit_torch.bench.train import PRESETS
    from icikit_torch.models.transformer import (TransformerConfig,
                                                 greedy_generate,
                                                 init_params,
                                                 loss_and_metrics,
                                                 make_model_mesh)
    from icikit_torch.ops import cuda_attention as ca
    from icikit_torch.ops.rope import rope_sincos

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(9)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def err(a, b) -> float:
        return float((a.float() - b.float()).abs().max())

    checks = []
    for dtype, key in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        tol, l2_tol = FLASH_TOL[key], BLOCK_L2_TOL[key]
        for b, h, s_, d in WIDE_SHAPES:
            q, k, v, do = (randn((b, h, s_, d), dtype) for _ in range(4))
            scale = d ** -0.5
            for causal in (True, False):
                out, lse = ca.flash_fwd(q, k, v, causal, scale)
                w_out, w_lse = ca.flash_fwd_plain(q, k, v, causal, scale)
                delta = (do.float() * out.float()).sum(-1)
                args = (q, k, v, do, lse, delta, causal, scale)
                want = ca.flash_bwd_plain(*args)
                got = {"flash_bwd": ca.flash_bwd(*args),
                       "two_pass": (ca.flash_bwd_dq(*args),
                                    *ca.flash_bwd_dkv(*args))}
                rel = {n: max(_rel(a, c) for a, c in zip(g, want))
                       for n, g in got.items()}
                l2 = {n: max(_block_rel_l2(a, c) for a, c in zip(g, want))
                      for n, g in got.items()}
                e_o, e_l = err(out, w_out), err(lse, w_lse)
                checks.append({
                    "kernel": "flash_fwd, flash_bwd, flash_bwd_dq + "
                              "flash_bwd_dkv", "dtype": key,
                    "shape": [b, h, s_, d], "causal": causal,
                    "out_err": e_o, "lse_err": e_l, "grad_rel_err": rel,
                    "grad_block_rel_l2": l2,
                    "ok": e_o <= tol["out"] and e_l <= tol["lse"]
                    and max(rel.values()) <= tol["grad"]
                    and max(l2.values()) <= l2_tol})
                del out, lse, w_out, w_lse, delta, want, got
            del q, k, v, do
        rows, total = 64, DEC_PROMPT + DEC_NEW
        for dh in (256, 384):
            for cur in sorted({0, min(300, total - 1), total - 1}):
                q, k, v = (randn((rows, dh), dtype) for _ in range(3))
                kc, vc = (randn((rows, total, dh), dtype) for _ in range(2))
                c, s_ = rope_sincos(torch.tensor([cur], device=dev), dh)
                cos2, sin2 = torch.cat([c, c], -1), torch.cat([s_, s_], -1)
                kc2, vc2 = kc.clone(), vc.clone()
                got = ca.decode_step(q, k, v, kc, vc, cur, cos2, sin2,
                                     scale=dh ** -0.5, rope=True)
                want = ca.decode_step_plain(q, k, v, kc2, vc2, cur, cos2,
                                            sin2, scale=dh ** -0.5, rope=True)
                e_o = err(got, want)
                same = bool(torch.equal(kc, kc2) and torch.equal(vc, vc2))
                checks.append({"kernel": "decode_step", "dtype": key,
                               "rows": rows, "total": total, "dh": dh,
                               "cur": cur, "out_err": e_o,
                               "cache_bitwise": same,
                               "ok": e_o <= tol["out"] and same})
    torch.cuda.synchronize()
    bad = [c for c in checks if not c["ok"]]

    # the d_head-256 path: a generate at bf16 with its launches counted
    # and at float32 against the plain arms; a float32 b 2 train step
    mesh = make_model_mesh(device=dev)
    base = dict(PRESETS[DEC_PRESET], **WIDE_CFG)
    cfg = TransformerConfig(**base, decode_step="fused",
                            attention_impl="flash")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    prompt = torch.randint(0, cfg.vocab, (DEC_BATCH, DEC_PROMPT),
                           generator=gen, device=dev, dtype=torch.int32)
    greedy_generate(params, prompt, mesh, cfg, 2)
    torch.cuda.synchronize()
    ca.reset_launches()
    out = greedy_generate(params, prompt, mesh, cfg, WIDE_NEW)
    torch.cuda.synchronize()
    launches = {k: n for k, n in ca.LAUNCHES.items() if n}
    want_l = {"flash_fwd": cfg.n_layers,
              "decode_step": cfg.n_layers * (WIDE_NEW - 1)}
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    t32, lg32 = greedy_generate(params, prompt, mesh, f32, WIDE_NEW,
                                return_logits=True)
    t32p, lg32p = greedy_generate(params, prompt, mesh, dataclasses.replace(
        f32, decode_step="unfused", attention_impl="dense"), WIDE_NEW,
        return_logits=True)
    div = _first_divergence(t32, t32p, lg32, lg32p, DEC_PROMPT,
                            FP32_LOGIT_TOL)
    bad_div = [r for r in div if r["max_logit_diff"] > FP32_LOGIT_TOL
               or (r["first_diff"] is not None and not r["near_tie"])]
    del lg32, lg32p
    tcfg = _train_config("float32", **WIDE_CFG)
    tok = torch.randint(0, cfg.vocab, (TRAIN_CHECK_BATCH, TRAIN_SEQ_WIDE),
                        generator=gen, device=dev, dtype=torch.int32)
    tgt = tok.roll(1, 1)
    ca.reset_launches()
    loss_k, g_k, _ = loss_and_metrics(params, tok, tgt, mesh, tcfg)
    torch.cuda.synchronize()
    t_launches = {k: n for k, n in ca.LAUNCHES.items() if n}
    loss_p, g_p, _ = loss_and_metrics(params, tok, tgt, mesh,
                                      dataclasses.replace(
                                          tcfg, attention_impl="dense",
                                          fused_head=False))
    train = {"loss": float(loss_k), "loss_plain": float(loss_p),
             "loss_diff": abs(float(loss_k) - float(loss_p)),
             "rel_l2_max": max(_rel_l2(g_k[k], g_p[k]) for k in g_p),
             "launches": t_launches}
    ok_path = (launches == want_l and not bad_div
               and tuple(out.shape) == (DEC_BATCH, DEC_PROMPT + WIDE_NEW)
               and t_launches == {"flash_fwd": tcfg.n_layers,
                                  "flash_bwd": tcfg.n_layers}
               and train["loss_diff"] <= TRAIN_LOSS_TOL
               and train["rel_l2_max"] <= TRAIN_GRAD_TOL)
    emit({"phase": "wide_head", "card": smi,
          "tolerance": {"flash": FLASH_TOL, "block_rel_l2": BLOCK_L2_TOL,
                        "decode_step": "out as flash's, cache bitwise",
                        "generate_fp32_logits": FP32_LOGIT_TOL,
                        "train_loss": TRAIN_LOSS_TOL,
                        "train_rel_l2": TRAIN_GRAD_TOL},
          "checks": checks,
          "generate": {"config": base, "batch": DEC_BATCH,
                       "prompt": DEC_PROMPT, "n_new": WIDE_NEW,
                       "launches_bf16": launches, "want": want_l,
                       "fp32_tokens_identical": bool(torch.equal(t32, t32p)),
                       "fp32_rows": div},
          "train_fp32_b2": dict(train, seq=TRAIN_SEQ_WIDE),
          "seconds": round(time.perf_counter() - t0, 1)})
    del params, g_k, g_p
    torch.cuda.empty_cache()
    if bad or not ok_path:
        raise AssertionError(f"d = 256 checks failed: kernels {bad}, path "
                             f"{launches} {bad_div} {train}")


def _q8_step_operands(torch, gen, dev, rows, total, dh, cur, qdtype):
    """The int8 step's operands: q, the fresh column (int8 and its
    dequant), int8 caches and their scale rows holding the column's."""
    from icikit_torch.ops.quant import dequantize_last, quantize_last

    q = torch.randn((rows, dh), generator=gen, device=dev).to(qdtype)
    kq, ks = quantize_last(torch.randn((rows, dh), generator=gen,
                                       device=dev))
    vq, vs = quantize_last(torch.randn((rows, dh), generator=gen,
                                       device=dev))
    kc, kcs = quantize_last(torch.randn((rows, total, dh), generator=gen,
                                        device=dev))
    vc, vcs = quantize_last(torch.randn((rows, total, dh), generator=gen,
                                        device=dev))
    kcs[:, cur], vcs[:, cur] = ks, vs
    return (q, kq, vq, dequantize_last(kq, ks), dequantize_last(vq, vs),
            kc, vc, kcs, vcs)


def int8_kernel_checks(torch, dev) -> None:
    """Phase 17: B15 at every (N, K) of the int8 path, rows 8 and 4096,
    and B14 at the path's step shape, against their plain versions."""
    from icikit_torch.ops import cuda_attention as ca
    from icikit_torch.ops import cuda_quant as cq

    gen = torch.Generator(device=dev).manual_seed(10)
    checks = []
    for dtype, key in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for rows in Q8_ROWS:
            for n, k in Q8_SHAPES.values():
                x = torch.randn((rows, k), generator=gen,
                                device=dev).to(dtype)
                w8 = torch.randint(-127, 128, (n, k), generator=gen,
                                   device=dev, dtype=torch.int8)
                sc = torch.rand((n,), generator=gen, device=dev) / 127
                got, want = cq.quant_matvec(x, w8, sc), \
                    cq.quant_matvec_plain(x, w8, sc)
                e = _rel(got, want)
                checks.append({"kernel": "quant_matvec", "dtype": key,
                               "rows": rows, "n": n, "k": k, "rel_err": e,
                               "ok": e <= QMV_TOL[key]})
                del x, w8, sc, got, want
        rows, total = DEC_BATCH * 8, DEC_PROMPT + DEC_NEW
        for dh in (128, 256):
            for cur in sorted({0, 1, min(300, total - 1), total - 1}):
                ops = _q8_step_operands(torch, gen, dev, rows, total, dh,
                                        cur, dtype)
                kc2, vc2 = ops[5].clone(), ops[6].clone()
                want = ca.decode_step_q8_plain(*ops[:5], kc2, vc2, *ops[7:],
                                               cur, scale=dh ** -0.5)
                got = ca.decode_step_q8(*ops, cur, scale=dh ** -0.5)
                e = float((got - want).abs().max())
                same = bool(torch.equal(ops[5], kc2)
                            and torch.equal(ops[6], vc2))
                checks.append({"kernel": "decode_step_q8", "q_dtype": key,
                               "rows": rows, "total": total, "dh": dh,
                               "cur": cur, "out_err": e,
                               "cache_bitwise": same,
                               "ok": e <= Q8_STEP_TOL and same})
    torch.cuda.synchronize()
    emit({"phase": "int8_kernels",
          "tolerance": {"quant_matvec": QMV_TOL, "decode_step_q8":
                        Q8_STEP_TOL,
                        "why": "quant_matvec: rel_err is the largest |error| "
                               "over the largest |reference| entry; the "
                               "products are exact in both (int8 in bf16 or "
                               "float32), the sums of K terms in other "
                               "orders (bf16 x on the tensor cores, float32 "
                               "x by FMA); decode_step_q8: the output "
                               "absolute, float32 sums in other orders, the "
                               "int8 cache columns bit for bit; TF32 off"},
          "checks": checks})
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise AssertionError(f"int8 kernel disagrees with its plain version: "
                             f"{bad}")


def int8_decode_path(torch, dev, bw, smi) -> dict:
    """Phase 18: the int8 decode path at the base preset; returns the
    kernel launches of its main run and its trace's device time by
    kernel."""
    import dataclasses

    from icikit_torch.bench.decode import decode_bytes_per_token, make_config
    from icikit_torch.models.transformer import (greedy_generate,
                                                 init_params,
                                                 make_model_mesh)
    from icikit_torch.models.transformer.decode import (
        _DecodeCtx, _prefill, maybe_quantize_params)
    from icikit_torch.ops import cuda_attention as ca
    from icikit_torch.ops import cuda_quant as cq
    from icikit_torch.utils.timing import cuda_time_ms, timeit_windows
    from icikit_torch.utils.trace import device_activity

    t0 = time.perf_counter()
    mesh = make_model_mesh(device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    plain = dict(decode_step="unfused", quant_matvec="xla",
                 attention_impl="dense")

    def config(dtype, **over):
        return make_config(DEC_PRESET, DEC_PROMPT, DEC_NEW,
                           **{"decode_step": "fused",
                              "attention_impl": "flash",
                              "decode_quant": "int8",
                              "quant_matvec": "auto",
                              "compute_dtype": dtype, **over})

    cfg = config("bfloat16")
    fp = init_params(cfg, gen, dev)          # phase 8's masters and prompt
    prompt = torch.randint(0, cfg.vocab, (DEC_BATCH, DEC_PROMPT),
                           generator=gen, device=dev, dtype=torch.int32)
    params = maybe_quantize_params(fp, mesh, cfg)   # once, outside timing

    # the main path's run, counted
    greedy_generate(params, prompt, mesh, cfg, 2)   # first-call set-up
    torch.cuda.synchronize()
    ca.reset_launches()
    cq.reset_launches()
    out, lg16 = greedy_generate(params, prompt, mesh, cfg, DEC_NEW,
                                return_logits=True)
    torch.cuda.synchronize()
    launches = {**ca.LAUNCHES, **cq.LAUNCHES}
    per_call = 4 * cfg.n_layers + 1
    want = {**dict.fromkeys(launches, 0), "flash_fwd": cfg.n_layers,
            "decode_step_q8": cfg.n_layers * (DEC_NEW - 1),
            "quant_matvec": per_call * DEC_NEW}
    if launches != want:
        raise AssertionError(f"int8 decode path launches {launches}, want "
                             f"{want}")
    ok_shape = (tuple(out.shape) == (DEC_BATCH, DEC_PROMPT + DEC_NEW)
                and bool(torch.equal(out[:, :DEC_PROMPT], prompt))
                and int(out.min()) >= 0 and int(out.max()) < cfg.vocab
                and bool(torch.isfinite(lg16).all()))
    if not ok_shape:
        raise AssertionError("int8 decode path output malformed")
    ctx = _DecodeCtx(cfg, params)
    _, (kcs, vcs, kss, vss) = _prefill(ctx, prompt, DEC_PROMPT,
                                       DEC_PROMPT + DEC_NEW, True)
    caches = {"k_v": sorted({str(c.dtype) for c in kcs + vcs}),
              "scales": sorted({str(c.dtype) for c in kss + vss}),
              "k_shape": list(kcs[0].shape), "scale_shape": list(kss[0].shape)}
    del ctx, kcs, vcs, kss, vss
    if caches["k_v"] != ["torch.int8"] or caches["scales"] != [
            "torch.float32"]:
        raise AssertionError(f"int8 path caches: {caches}")

    # bf16 against the plain arms: first-step logits; token agreement with
    # the bf16 (unquantized) fused path, as information
    out_p, lg16_p = greedy_generate(params, prompt, mesh,
                                    config("bfloat16", **plain), DEC_NEW,
                                    return_logits=True)
    d16 = (lg16[0] - lg16_p[0]).abs()
    out_fp = greedy_generate(fp, prompt, mesh, config(
        "bfloat16", decode_quant="none"), DEC_NEW)
    bf16 = {"first_logits_max_diff": float(d16.max()),
            "first_logits_mean_diff": float(d16.mean()),
            "tolerance": BF16_LOGIT_TOL,
            "token_equal_share_plain_arms": float(
                (out[:, DEC_PROMPT:] == out_p[:, DEC_PROMPT:]).float().mean()),
            "token_agreement_with_bf16_path_info": float(
                (out[:, DEC_PROMPT:] == out_fp[:, DEC_PROMPT:]).float()
                .mean())}
    del lg16, lg16_p

    # float32: tokens identical up to near-ties
    c32 = config("float32")
    t32, lg32 = greedy_generate(params, prompt, mesh, c32, DEC_NEW,
                                return_logits=True)
    t32p, lg32p = greedy_generate(params, prompt, mesh,
                                  config("float32", **plain), DEC_NEW,
                                  return_logits=True)
    rows = _first_divergence(t32, t32p, lg32, lg32p, DEC_PROMPT,
                             INT8_FP32_LOGIT_TOL)
    fp32 = {"tokens_identical": bool(torch.equal(t32, t32p)),
            "logit_tolerance": INT8_FP32_LOGIT_TOL, "rows": rows}
    del lg32, lg32p
    emit({"phase": "int8_decode_check", "preset": DEC_PRESET,
          "batch": DEC_BATCH, "prompt": DEC_PROMPT, "n_new": DEC_NEW,
          "launches": launches, "caches": caches, "bf16": bf16, "fp32": fp32,
          "fp32_tolerance_why": "a K/V element within float32 rounding of "
                                "an int8 rounding boundary quantizes to the "
                                "neighbouring value in one arm (the kernel "
                                "and cuBLAS sum the projections in other "
                                "orders); one int8 step of a K column moves "
                                "an attention logit by "
                                "|q_d| amax/127/sqrt(dh)",
          "seconds": round(time.perf_counter() - t0, 1)})
    bad32 = [r for r in rows if r["max_logit_diff"] > INT8_FP32_LOGIT_TOL
             or (r["first_diff"] is not None and not r["near_tie"])]
    if bad32 or bf16["first_logits_max_diff"] > BF16_LOGIT_TOL:
        raise AssertionError(f"int8 decode path disagrees with its plain "
                             f"arms: fp32 {bad32}, bf16 {bf16}")

    # timing: the int8 fused arm beside phase 8's bf16 fused arm
    ctr = [0]

    def chain(args, o):
        ctr[0] += 1
        nxt = o[:, -DEC_PROMPT:].clone()
        nxt[0, 0] = ctr[0] % cfg.vocab
        return (nxt,)

    cache_len = DEC_PROMPT + DEC_NEW
    bytes8 = decode_bytes_per_token(cfg, DEC_BATCH, cache_len,
                                    bytes_dtype="int8")
    bytes16 = decode_bytes_per_token(cfg, DEC_BATCH, cache_len)
    arms = {}
    for name, c, p, nbytes in (
            ("int8_fused", cfg, params, bytes8),
            ("bf16_fused", dataclasses.replace(cfg, decode_quant="none"), fp,
             bytes16)):
        res = timeit_windows(
            lambda x, c=c, p=p: greedy_generate(p, x, mesh, c, DEC_NEW),
            (prompt,), chain, windows=3, runs=2, warmup=1,
            floor_s=DEC_NEW * nbytes / bw)
        arms[name] = {"per_token_ms": res.median_s / DEC_NEW * 1e3,
                      "spread_ms": [res.min_s / DEC_NEW * 1e3,
                                    res.max_s / DEC_NEW * 1e3],
                      "tokens_per_s": DEC_BATCH * DEC_NEW / res.median_s,
                      "generate_ms": res.median_s * 1e3,
                      "bound_ms_per_token": nbytes / bw * 1e3,
                      "windows": res.windows, "suspect": res.suspect}
    prefill_ms = cuda_time_ms(
        lambda: greedy_generate(params, prompt, mesh, cfg, 1), iters=5)
    activity = device_activity(
        lambda: greedy_generate(params, prompt, mesh, cfg, DEC_NEW))
    emit({"phase": "int8_decode_timing", "card": smi, "arms": arms,
          "prefill_ms": prefill_ms,
          "step_ms_excluding_prefill": (arms["int8_fused"]["generate_ms"]
                                        - prefill_ms) / (DEC_NEW - 1),
          "bound_ms_per_token": bytes8 / bw * 1e3, "bytes_per_token": bytes8,
          "read_gbps": bytes8 / (arms["int8_fused"]["per_token_ms"] * 1e-3)
          / 1e9,
          "profile": activity,
          "seconds": round(time.perf_counter() - t0, 1)})
    del params, fp
    torch.cuda.empty_cache()
    return launches, activity["by_name"]


def int8_rows(torch, dev, bw, launches, path_trace) -> list:
    """Phase 19's rows for B15 and B14, timed at the int8 path's shapes
    by CUDA events around back-to-back launches, as every row is; beside
    them in the phase line, each kernel's device time a launch in phase
    18's trace of the main path (``path_trace``: its ``by_name``). At
    the step's 8 rows a launch takes less device time than the host
    takes to issue it, so the events there time the host."""
    from icikit_torch.ops import cuda_attention as ca
    from icikit_torch.ops import cuda_quant as cq
    from icikit_torch.utils.timing import cuda_time_ms

    gen = torch.Generator(device=dev).manual_seed(11)
    bf = torch.bfloat16

    def bound(nbytes, ops, rate):
        t_b, t_o = nbytes / bw, ops / rate
        return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"

    rows_out, shapes = [], {}
    for rows in Q8_ROWS:
        for name, (n, k) in Q8_SHAPES.items():
            x = torch.randn((rows, k), generator=gen, device=dev).to(bf)
            w8 = torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                               dtype=torch.int8)
            sc = torch.rand((n,), generator=gen, device=dev) / 127
            it = 100 if rows <= 16 else 10
            k_ms = cuda_time_ms(lambda: cq.quant_matvec(x, w8, sc),
                                iters=it, warmup=3)
            p_ms = cuda_time_ms(lambda: cq.quant_matvec_plain(x, w8, sc),
                                iters=10, warmup=2)
            w16 = w8.to(bf)
            mm_ms = cuda_time_ms(lambda: torch.matmul(x, w16.t()), iters=it,
                                 warmup=3)
            try:
                s16 = sc.to(bf)
                lib_ms = cuda_time_ms(lambda: torch._weight_int8pack_mm(
                    x, w8, s16), iters=it, warmup=3)
            except (RuntimeError, NotImplementedError) as exc:
                lib_ms, lib_why = None, f"{type(exc).__name__}: {exc}"[:160]
            else:
                lib_why = "torch._weight_int8pack_mm (bf16 out)"
            b_ms, b_by = bound(n * k + rows * k * 2 + n * 4 + rows * n * 4,
                               2 * rows * n * k, BF16_TENSOR_OPS)
            e = _rel(cq.quant_matvec(x, w8, sc), cq.quant_matvec_plain(x, w8,
                                                                       sc))
            shapes[f"{name} rows {rows}"] = {
                "n": n, "k": k, "ms": k_ms, "plain_ms": p_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                "library": lib_why, "cublas_bf16_ms": mm_ms, "rel_err": e}
            if (name, rows) in Q8_ROW_ENTRIES:
                rows_out.append({
                    "name": f"quant_matvec (B15) {name}, rows {rows}",
                    "route": "cuda", "source": "icikit_torch/csrc/quant.cu",
                    "replaces": "icikit/ops/quant.py:167 (B15, "
                                "_matvec_kernel :108)",
                    "launches": launches["quant_matvec"], "max_abs_err": e,
                    "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": lib_ms})
            del x, w8, sc, w16
    r_, total, dh = DEC_BATCH * 8, DEC_PROMPT + DEC_NEW, 128
    cur = DEC_PROMPT + (DEC_NEW - 1) // 2       # the steps' mean column
    ops = _q8_step_operands(torch, gen, dev, r_, total, dh, cur, bf)
    s_ms = cuda_time_ms(lambda: ca.decode_step_q8(*ops, cur,
                                                  scale=dh ** -0.5),
                        iters=100, warmup=5)
    s_plain = cuda_time_ms(lambda: ca.decode_step_q8_plain(
        *ops, cur, scale=dh ** -0.5), iters=10)
    s_err = float((ca.decode_step_q8(*ops, cur, scale=dh ** -0.5)
                   - ca.decode_step_q8_plain(*ops[:5], ops[5].clone(),
                                             ops[6].clone(), *ops[7:], cur,
                                             scale=dh ** -0.5)).abs().max())
    s_bytes = (2 * r_ * cur * dh + 2 * r_ * cur * 4   # int8 K/V, scales
               + r_ * dh * 2 + 2 * r_ * dh + 2 * r_ * dh * 4  # q, columns
               + r_ * dh * 4 + 2 * r_ * dh)           # out, column writes
    s_bound, s_by = bound(s_bytes, 2 * 2 * r_ * (cur + 1) * dh, VECTOR_OPS)
    rows_out.append({
        "name": "decode_step_q8 (B14)", "route": "cuda",
        "source": "icikit_torch/csrc/attention.cu",
        "replaces": "icikit/ops/flash_attention.py:1229 (B14, "
                    "_decode_step_q8_kernel :1137)",
        "launches": launches["decode_step_q8"], "max_abs_err": s_err,
        "ms": s_ms, "plain_ms": s_plain, "bound_ms": s_bound,
        "bound_by": s_by, "library_ms": None})
    torch.cuda.synchronize()
    path_us = {k: 1e3 * v["ms"] / v["count"] for k, v in path_trace.items()
               if k in ("qmv_bf16_skinny", "qmv_bf16_tile",
                        "decode_step_q8_kernel")}
    emit({"phase": "int8_timing_kernels", "quant_matvec": shapes,
          "ms": "CUDA events around 100 (rows 8) or 10 back-to-back "
                "calls; at rows 8 they time the host's launches",
          "path_trace_device_us_per_launch": path_us,
          "quant_matvec_bound": "int8 weights, bf16 x, float32 scales and "
                                "out once; products at the bf16 tensor "
                                "rate",
          "decode_step_q8": f"rows={r_} total={total} dh={dh} cur={cur} "
                            f"bf16 q, {s_bytes} bytes",
          "decode_step_q8_library": "none: no one PyTorch call writes the "
                                    "int8 column and attends over int8 "
                                    "caches with folded scales",
          "max_abs_err": "quant_matvec relative to the largest entry; "
                         "decode_step_q8 absolute"})
    return rows_out


def tile_floor_kernel_checks(torch, dev) -> None:
    """Phase 20: B17's five kernels against their plain versions at
    TILE_CHECK, head dims 64 and 128, bq = bk = 64."""
    from icikit_torch.bench.tile_floor import ABLATIONS, LOG2E_JAX
    from icikit_torch.ops import cuda_tile_floor as ctf

    gen = torch.Generator(device=dev).manual_seed(8)
    b, h, s = TILE_CHECK
    checks = []
    for d in TILE_DIMS:
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        scale_log2 = d ** -0.5 * LOG2E_JAX
        pairs = [("mxu", ctf.tile_mxu(q, k, v, scale_log2),
                  ctf.mxu_plain(q, k, v, scale_log2))]
        pairs += [(name, ctf.tile_ablate(q, k, v, scale_log2, e, m),
                   ctf.ablate_plain(q, k, v, scale_log2, e, m))
                  for name, e, m in ABLATIONS]
        for name, got, want in pairs:
            err = _rel(got, want)
            finite = bool(torch.isfinite(got.float()).all())
            checks.append({"variant": name, "d": d, "rel_err": err,
                           "finite": finite,
                           "ok": finite and err <= TILE_TOL})
    torch.cuda.synchronize()
    emit({"phase": "tile_floor_kernels", "shape": [b, h, s],
          "dims": list(TILE_DIMS), "tolerance": TILE_TOL,
          "why": "bf16: the kernel and the plain version round w to bf16 "
                 "at scores whose float32 sums differ in order, so a "
                 "score on a rounding boundary rounds apart; the error "
                 "is relative to the largest |plain| entry",
          "checks": checks})
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise AssertionError(f"tile-floor kernel disagrees with its plain "
                             f"version: {bad}")


def tile_floor_path(torch, dev, bw, smi) -> list:
    """Phase 21: the tile-floor study (``bench.tile_floor.measure``) at
    TILE_PATH for each head dim, its launches counted; then B17's five
    kernels against their plain versions at the path's shapes, both head
    dims, within TILE_TOL; returns the rows of B17's kernels timed at the
    path's d = 64 shape."""
    from icikit_torch.bench.tile_floor import (ABLATIONS, LOG2E_JAX,
                                               measure, render, tile_ops)
    from icikit_torch.ops import cuda_attention as ca
    from icikit_torch.ops import cuda_tile_floor as ctf
    from icikit_torch.utils.timing import cuda_time_ms

    t0 = time.perf_counter()
    h, seq = TILE_PATH
    results = {}
    ctf.reset_launches()
    ca.reset_launches()
    for d in TILE_DIMS:
        recs = measure(seq, d=d, h=h, windows=3, device=dev)
        results[d] = {r["variant"]: r for r in recs}
    torch.cuda.synchronize()
    launches = {**ctf.LAUNCHES, "flash_fwd": ca.LAUNCHES["flash_fwd"]}
    ok = all(n > 0 for n in launches.values()) and all(
        r["per_tile_us"] > 0 and r["tiles"] > 0
        for by in results.values() for r in by.values())
    for d, by in results.items():
        bound_us = tile_ops(64, 64, d) / BF16_TENSOR_OPS * 1e6
        emit({"phase": "tile_floor", "card": smi, "h": h, "seq": seq,
              "d": d, "launches": launches,
              "per_tile_us": {n: r["per_tile_us"] for n, r in by.items()},
              "per_tile_bound_us": bound_us,
              "bound_by": "operations (4 bq bk d at 989 TFLOP/s)",
              "tiles": {n: r["tiles"] for n, r in by.items()},
              "median_s": {n: r["median_s"] for n, r in by.items()},
              "spread_s": {n: r["spread_s"] for n, r in by.items()},
              "session_quality": by["mxu"]["session_quality"],
              "render": render(list(by.values())).splitlines(),
              "seconds": round(time.perf_counter() - t0, 1)})
    if not ok:
        raise AssertionError(f"tile-floor path: a kernel was not launched "
                             f"or a variant gave no time: {launches}")

    # B17's five kernels against their plain versions at the path's
    # shapes, both head dims (these launches come after the count); then
    # at d = 64 each kernel timed beside its plain version, and
    # softmax_ks1 beside the one PyTorch call that computes its function,
    # non-causal scaled_dot_product_attention
    gen = torch.Generator(device=dev).manual_seed(9)
    checks, rows, timing = [], [], {}
    for d in TILE_DIMS:
        q, k, v = (torch.randn((1, h, seq, d), generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        scale_log2 = d ** -0.5 * LOG2E_JAX
        variants = {"mxu": (
            "tile_mxu", lambda: ctf.tile_mxu(q, k, v, scale_log2),
            lambda: ctf.mxu_plain(q, k, v, scale_log2))}
        for name, e, m in ABLATIONS:
            variants[name] = (
                "tile_ablate",
                lambda e=e, m=m: ctf.tile_ablate(q, k, v, scale_log2, e, m),
                lambda e=e, m=m: ctf.ablate_plain(q, k, v, scale_log2, e, m))
        errs = {}
        for name, (_, kern, plain) in variants.items():
            got, want = kern(), plain()
            errs[name] = _rel(got, want)
            finite = bool(torch.isfinite(got.float()).all())
            checks.append({"variant": name, "d": d, "rel_err": errs[name],
                           "finite": finite,
                           "ok": finite and errs[name] <= TILE_TOL})
            del got, want
        if d != TILE_DIMS[0]:
            del q, k, v
            continue
        tiles = h * (seq // ctf.TILE) ** 2
        t_ops = tiles * tile_ops(ctf.TILE, ctf.TILE, d) / BF16_TENSOR_OPS
        t_bytes = 4 * q.numel() * 2 / bw
        bound_ms = max(t_ops, t_bytes) * 1e3
        bound_by = "operations" if t_ops >= t_bytes else "bytes"

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, scale=d ** -0.5)

        lib_ms = cuda_time_ms(sdpa, iters=3, warmup=1)
        timing = {"library_rel_err_vs_softmax_ks1": _rel(
            sdpa(), ctf.ablate_plain(q, k, v, scale_log2, True, True))}
        for name, row_name in (("mxu", "tile_mxu (B17)"),
                               ("softmax_ks1",
                                "tile_ablate softmax_ks1 (B17)")):
            key, kern, plain = variants[name]
            rows.append({
                "name": row_name, "route": "cuda",
                "source": "icikit_torch/csrc/tile_floor.cu",
                "replaces": (
                    "icikit/bench/tile_floor.py:174 (B17, _mxu_kernel)"
                    if key == "tile_mxu" else
                    "icikit/bench/tile_floor.py:199 (B17, _ablate_kernel)"),
                "launches": launches[key], "max_abs_err": errs[name],
                "ms": cuda_time_ms(kern, iters=3, warmup=1),
                "plain_ms": cuda_time_ms(plain, iters=1, warmup=1),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib_ms if name == "softmax_ks1" else None})
        del q, k, v
    torch.cuda.synchronize()
    emit({"phase": "tile_floor_path_checks", "h": h, "seq": seq,
          "dims": list(TILE_DIMS), "tolerance": TILE_TOL,
          "why": "as phase 20, at the path's shapes",
          "checks": checks})
    emit({"phase": "tile_floor_timing_kernels", "card": smi,
          "shape": f"b=1 h={h} s={seq} d={TILE_DIMS[0]} bf16, the full "
                   f"rectangle of {h * (seq // ctf.TILE) ** 2} 64 x 64 "
                   "tiles",
          "launches": "the tile-floor path's, both head dims (tile_ablate "
                      "over its four variants)",
          "library": "softmax_ks1: non-causal scaled_dot_product_attention "
                     "at scale d**-0.5 (softmax attention, the function "
                     "the online softmax computes); mxu: none, no PyTorch "
                     "call computes its unnormalized sum",
          "max_abs_err": "relative to the largest |plain| entry",
          **timing})
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise AssertionError(f"tile-floor kernel disagrees with its plain "
                             f"version at the path's shapes: {bad}")
    torch.cuda.empty_cache()
    return rows


def stack_kernel_checks(torch, dev) -> None:
    """Phase 22: B16's kernels against their plain versions, bit for bit,
    at every slice shape and dtype of the save-stack path's stacks and
    the slices STACK_CHECK_I; a slice off JAX's gate takes the plain copy
    and launches nothing."""
    from icikit_torch.ops import cuda_stack as cst
    from icikit_torch.ops import stack_write as sw

    gen = torch.Generator(device=dev).manual_seed(10)
    n_layers = SAVE_STACK_LAUNCHES["stack_read"]
    checks = []

    def bits(t):
        return t.view(torch.int16 if t.element_size() == 2 else torch.int32)

    for name, (shape, dtype) in {**STACK_SLICES,
                                 "off the gate": STACK_OFF_GATE}.items():
        dt = getattr(torch, dtype)
        stack = torch.randn((n_layers,) + shape, generator=gen,
                            device=dev).to(dt)
        want = stack.clone()
        gated = sw.stack_supported(shape, dt)
        cst.reset_launches()
        same = True
        for i in STACK_CHECK_I:
            x = torch.randn(shape, generator=gen, device=dev)
            sw.stack_write(stack, x, i)
            cst.stack_write_plain(want, x.to(dt), i)
            same = (same and torch.equal(bits(stack), bits(want))
                    and torch.equal(bits(sw.stack_read(stack, i)),
                                    bits(cst.stack_read_plain(want, i))))
        torch.cuda.synchronize()
        n = len(STACK_CHECK_I) if gated else 0
        launched = dict(cst.LAUNCHES)
        checks.append({"stack": name, "slice": list(shape), "dtype": dtype,
                       "on_gate": gated, "launches": launched,
                       "bitwise": same,
                       "ok": same and launched == {"stack_write": n,
                                                   "stack_read": n}})
        del stack, want
    emit({"phase": "stack_kernels", "layers": n_layers,
          "slices": list(STACK_CHECK_I), "tolerance": "bit for bit (a copy)",
          "checks": checks})
    bad = [c for c in checks if not c["ok"]]
    if bad or checks[-1]["on_gate"]:
        raise AssertionError(f"save-stack kernel disagrees with its plain "
                             f"version or routes wrongly: {checks}")


def save_stack_path(torch, dev, bw, smi, default_ms) -> list:
    """Phase 23: the base train step with ``save_stack="pallas"``
    (``SAVE_STACK_ARM``), its launches asserted, held at b = 2
    and float32 against the default and plain arms, then timed beside a
    second run of the default arm; returns B16's rows at the path's
    shapes."""
    from icikit_torch.bench.stream_ab import device_ms, run_copy, run_host
    from icikit_torch.ops import cuda_stack as cst

    t0 = time.perf_counter()
    cell = train_cell(torch, dev)
    rec = train_arm(torch, cell, "save-stack", SAVE_STACK_ARM, smi,
                    phase="save_stack")
    again = train_arm(torch, cell, "default", ARMS["default"])
    emit({"phase": "save_stack_ab", "card": smi,
          "step_ms": {"default (phase 11)": default_ms,
                      "save-stack": rec["step_ms"],
                      "default (again)": again["step_ms"]},
          "spread_ms": {"save-stack": rec["step_ms_spread"],
                        "default (again)": again["step_ms_spread"]},
          "tokens_per_s": {"save-stack": rec["tokens_per_s"],
                           "default (again)": again["tokens_per_s"]},
          "mfu": {"save-stack": rec["mfu"], "default (again)": again["mfu"]},
          "seconds": round(time.perf_counter() - t0, 1)})
    if not (rec["ok"] and again["ok"]):
        raise AssertionError(f"save-stack path disagrees with its plain "
                             f"arms, launches otherwise or does not learn: "
                             f"{rec} {again}")
    del cell
    torch.cuda.empty_cache()

    # B16's kernels at the residual slice, the path's largest, cold: the
    # 12 slices of a (12, ...) stack in rotation (192 MiB, past the 50 MB
    # L2); device time a launch by CUDA events over launches queued
    # behind a sleep kernel, beside copy_ timed the same way
    gen = torch.Generator(device=dev).manual_seed(11)
    shape = STACK_SLICES["residual"][0]
    n_slices = SAVE_STACK_LAUNCHES["stack_read"]
    stack = torch.randn((n_slices,) + shape, generator=gen,
                        device=dev).to(torch.bfloat16)
    x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    out = torch.empty_like(x)
    nbytes = x.numel() * 2
    launches = rec["launches_per_step"]
    traced = {k: v for k, v in rec["profile"]["by_name"].items()
              if k.startswith("stack_")}

    def rotating(fn):
        it = itertools.cycle(range(n_slices))
        return lambda: fn(next(it))

    rows = []
    for key, kern, plain, lib, check in (
            ("stack_write", lambda i: cst.stack_write(stack, x, i),
             lambda i: cst.stack_write_plain(stack, x, i),
             lambda i: stack[i].copy_(x),
             lambda: float((cst.stack_write(stack.clone(), x, 5)[5].float()
                            - x.float()).abs().max())),
            ("stack_read", lambda i: cst.stack_read(stack, i),
             lambda i: cst.stack_read_plain(stack, i),
             lambda i: out.copy_(stack[i]),
             lambda: float((cst.stack_read(stack, 5).float()
                            - stack[5].float()).abs().max()))):
        rows.append({
            "name": f"{key} (B16)", "route": "cuda",
            "source": "icikit_torch/csrc/stack_write.cu",
            "replaces": ("icikit/ops/stack_write.py:126 (B16, "
                         "_write_kernel)" if key == "stack_write" else
                         "icikit/ops/stack_write.py:158 (B16, _read_kernel)"),
            "launches": launches[key], "max_abs_err": check(),
            "ms": device_ms(rotating(kern), 240, 60.0),
            "plain_ms": device_ms(rotating(plain), 240, 60.0),
            "bound_ms": 2 * nbytes / bw * 1e3, "bound_by": "bytes",
            "library_ms": device_ms(rotating(lib), 240, 60.0)})
    torch.cuda.synchronize()
    del stack, x, out
    torch.cuda.empty_cache()
    host = run_host(gen)
    copy = run_copy()
    emit({"phase": "save_stack_timing_kernels", "card": smi,
          "shape": f"the residual slice {list(shape)} bf16 ({nbytes} "
                   f"bytes) of a ({n_slices}, ...) stack, the slices in "
                   "rotation (cold)",
          "ms": "device time a launch: CUDA events over 240 launches "
                "queued behind a sleep kernel, so the host's call rate "
                "does not show",
          "device_ms_a_launch_in_step_trace": {
              k: v["ms"] / v["count"] for k, v in traced.items()},
          "device_ms_in_step_trace": traced,
          "library": "stack[i].copy_(x) for the write, out.copy_(stack[i]) "
                     "into a preallocated slice for the read, rotating",
          "host_us_a_call": host, "copy_1GiB": copy,
          "launches": "a save-stack step's"})
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
              "decode_step_kernel<bf16>", "flash_bwd_bf16<128>",
              "flash_bwd_f32<128>", "flash_bwd_dq_bf16<128>",
              "flash_bwd_dq_f32<128>", "flash_bwd_dkv_bf16<128>",
              "flash_fwd_bf16<256>", "flash_fwd_f32<256>",
              "flash_bwd_bf16<256>", "flash_bwd_f32<256>",
              "flash_bwd_dq_bf16<256>", "flash_bwd_dq_f32<256>",
              "flash_bwd_dkv_bf16<256>", "flash_bwd_dkv_f32<256>",
              "decode_step_q8_kernel<bf16>",
              "decode_step_q8_kernel<float>",
              "flash_bwd_bf16<32>", "flash_bwd_bf16<64>",
              "flash_bwd_dq_bf16<32>", "flash_bwd_dq_bf16<64>",
              "flash_bwd_dkv_bf16<32>", "flash_bwd_dkv_bf16<64>",
              "flash_fwd_bf16<32>", "flash_fwd_bf16<64>")),
            ("quant", "icikit_quant_regs",
             ("qmv_bf16_skinny", "qmv_bf16_tile", "qmv_f32<16, 32>",
              "qmv_f32<64, 64>")),
            ("xent", "icikit_xent_regs",
             ("xent_fwd_bf16", "xent_dx_bf16", "xent_dw_bf16",
              "xent_fwd_f32", "xent_g_bf16", "xent_g_saved_bf16",
              "xent_recompute_bf16<dx>", "xent_recompute_bf16<dw>")),
            ("adam", "icikit_adam_regs",
             ("adam_tree_kernel<f32 moments>",
              "adam_tree_kernel<bf16 moments>")),
            ("stack_write", "icikit_stack_regs",
             ("stack_write_kernel", "stack_read_kernel")),
            ("tile_floor", "icikit_tile_floor_regs",
             ("tile_mxu<64>", "tile_ablate<64, exp2, max>",
              "tile_ablate<64, -, ->", "tile_mxu<128>",
              "tile_ablate<128, exp2, max>"))):
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
    spilled = {k: regs[k] for k in NO_LOCAL_MEMORY
               if regs[k]["local_bytes"]}
    if spilled:
        raise AssertionError(f"kernels use local memory: {spilled}")

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
    cell = train_cell(torch, dev)
    main_arm = train_arm(torch, cell, "default", ARMS["default"], smi)
    if not main_arm["ok"]:
        raise AssertionError(f"train path disagrees with its plain arms or "
                             f"does not learn: {main_arm}")
    train_launches = main_arm["launches_per_step"]

    # -- 12. per-kernel numbers at the train path's shapes -------------
    rows += train_rows(torch, dev, bw, train_launches)

    # -- 13. the train step's other kernels against their plain versions
    train_arm_kernel_checks(torch, dev)

    # -- 14. the train arms: base, b = 8, s = 1024 -----------------------
    rows += train_arms(torch, dev, bw, smi, cell)
    del cell

    # -- 15. the long-context path: s = 32768 and 131072 ----------------
    rows += long_context(torch, dev, bw, smi)

    # -- 16. d = 256: the flash kernels, the step, a generate, a step ----
    wide_head_checks(torch, dev, smi)

    # -- 17. the int8 kernels against their plain versions --------------
    int8_kernel_checks(torch, dev)

    # -- 18. the int8 decode path: base, b = 8, prompt 512, 64 new ------
    q8_launches, q8_trace = int8_decode_path(torch, dev, bw, smi)

    # -- 19. per-kernel numbers at the int8 path's shapes ---------------
    rows += int8_rows(torch, dev, bw, q8_launches, q8_trace)

    # -- 20. B17's kernels against their plain versions ------------------
    tile_floor_kernel_checks(torch, dev)

    # -- 21. the tile-floor path: s = 32768, h 8, d 64 and 128 ----------
    rows += tile_floor_path(torch, dev, bw, smi)

    # -- 22. B16's kernels against their plain versions ------------------
    stack_kernel_checks(torch, dev)

    # -- 23. the save-stack train path: base, b = 8, s = 1024 ----------
    rows += save_stack_path(torch, dev, bw, smi, main_arm["step_ms"])

    # -- 24. the kernels line --------------------------------------------
    emit({"phase": "done", "seconds": round(time.perf_counter() - t_start,
                                            1)})
    emit({"kernels": rows})
    print(smi)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
