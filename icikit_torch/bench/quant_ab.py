"""The int8 matvec at the decode step's rows (B15's skinny kernel) of two
``quant.cu`` sources, timed in turns on one card.

Builds each source with ``nvcc`` (for ``sm_90a``, ``-Xptxas -v``)
through ``ops._build.build_sources`` into its own library under
``icikit_torch/build/ab/``, named by a hash of the source and the flags,
then, at each of the int8 decode path's five products (``base``: wqkv,
wo, w1, w2 of every layer and the unembedding w_out) at rows 8, bf16 x,
times source A, B, B, A by CUDA events over launches queued behind a
sleep kernel (device time a launch; the host issues a launch more
slowly than the card runs it). Each call takes the next of enough
copies of the weights to pass 256 MiB (``stream_ab.ROTATE_BYTES``), so
that they come from device memory as on the path, where a step streams 176 MB of int8 weights
through the 50 MB L2. Beside them, timed the same way:
``torch._weight_int8pack_mm`` (bf16 out; the library row) and cuBLAS's
bf16 ``x @ w.T`` on bf16 copies of the weights, which read twice the
bytes; and B at each other number of K splits its entry takes (1, 2, 4,
8, 16 where valid), for its split picker, and an empty launch (a
one-element ``add_``), the floor of a launch in this protocol.

A source that exports ``icikit_quant_matvec_split`` takes that entry (its
splits from ``ops.cuda_quant.skinny_splits``), one that does not (the
design before it) the parent's ``icikit_quant_matvec``. Each arm's
output is held to ``quant_matvec_plain`` within 1e-4 of the largest
entry (``chip_smoke.py``'s QMV_TOL), and B's repeats bit for bit from
call to call: a departure marks the record ``"ok": false`` and the run
exits 1 unless ``--timing-only``. Bound: the int8 weights, x, the scales
and the float32 output once at 3.35 TB/s against the products at 989
TFLOP/s, the larger. Prints one JSON line a shape, the step's sum (12
layers of four products and w_out), the kernels' registers and spills as
ptxas reported them, and the card's name and power limit. Needs a CUDA
card.

    python -m icikit_torch.bench.quant_ab --a OLD.cu \\
        --b icikit_torch/csrc/quant.cu

With ``--rows 4096`` it times the prefill's tile kernel instead
(``qmv_bf16_tile``, rows b * s = 4096 at ``base``): the four products a
layer (wqkv, wo, w1, w2; 12 layers, 48 launches a generate), A, B, B, A
by CUDA events around back-to-back launches on the same tensors (the
products bound them, not the weights' bytes), beside the same bound,
``torch._weight_int8pack_mm`` and cuBLAS's bf16 ``x @ w.T``; each arm
held to the plain version within TOL and B to its own bits from call to
call; the layer's sum of each arm.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import torch

from icikit_torch.ops import _build

MEM_BPS = 3.35e12          # H100 SXM HBM3, NVIDIA's data sheet
BF16_TENSOR_OPS = 989e12   # dense bf16, the same
# (N, K) of the int8 decode path's products at base, and how many run a
# step (12 layers of four, the unembedding once)
SHAPES = {"wqkv": (3072, 1024), "wo": (1024, 1024), "w1": (4096, 1024),
          "w2": (1024, 4096), "w_out": (32768, 1024)}
PER_STEP = {"wqkv": 12, "wo": 12, "w1": 12, "w2": 12, "w_out": 1}
ROWS = 8                   # the step's b
PREFILL_ROWS = 4096        # the prefill's b * s
# the prefill's products: each once a layer (w_out runs on the last
# position only, at the step's rows)
PREFILL_SHAPES = ("wqkv", "wo", "w1", "w2")
LAYERS = 12
PREFILL_ITERS = 20
TOL = 1e-4                 # of the largest |plain| entry
SPLIT_SWEEP = (1, 2, 4, 8, 16)
ITERS = 200
# the parent's C entry, before the split one
_ROW_ENTRY = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 \
    + [ctypes.c_void_p]


def bound_ms(n: int, k: int, rows: int = ROWS) -> tuple:
    """(ms, "bytes" or "operations"): int8 weights, bf16 x, float32
    scales and output once, against the products at the bf16 rate."""
    nbytes = n * k + rows * k * 2 + n * 4 + rows * n * 4
    t_b, t_o = nbytes / MEM_BPS, 2 * rows * n * k / BF16_TENSOR_OPS
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def valid_splits(k: int, splits: int, rows: int = ROWS) -> bool:
    """Does the skinny entry take ``splits`` at contraction ``k``? At
    most K's 64-wide chunks, at most the chunks a CTA holds."""
    from icikit_torch.ops.cuda_quant import SKINNY_CHUNK, skinny_chunks_max

    chunks = k // SKINNY_CHUNK
    return 1 <= splits <= chunks and -(-chunks // splits) <= \
        skinny_chunks_max(rows)


def step_ms(per_shape: dict) -> float:
    """The step's sum of ``{shape: ms}``: PER_STEP launches of each."""
    return sum(PER_STEP[s] * ms for s, ms in per_shape.items())


def layer_ms(per_shape: dict) -> float:
    """A layer's sum of ``{shape: ms}`` at the prefill: one launch of
    each of PREFILL_SHAPES."""
    return sum(per_shape[s] for s in PREFILL_SHAPES)


def build(sources: dict) -> dict:
    """{name: (library, registers)}, the sources compiled in parallel."""
    from icikit_torch.bench.flash_ab import _ptxas_regs

    built = _build.build_sources("quant", sources,
                                 os.path.join(_build.BUILD_DIR, "ab"),
                                 ("-Xptxas", "-v"))
    return {n: (lib, _ptxas_regs(log, lambda name: "qmv_" in name))
            for n, (lib, log) in built.items()}


def matvec_call(lib, x, scale, out, splits=None):
    """One source's bf16 matvec into ``out``, as ``call(w8)``: the split
    entry where the library has it (``splits`` or the picker's), else
    the parent's."""
    from icikit_torch.ops import cuda_quant as cq

    rows, k = x.shape
    n = out.shape[1]
    st = torch.cuda.current_stream().cuda_stream
    if hasattr(lib, "icikit_quant_matvec_split"):
        splits = splits or cq.skinny_splits(rows, k)
        tiles = n // cq.SKINNY_CHANNELS
        ws = torch.empty(tiles * splits * cq.SKINNY_CHANNELS
                         * cq.SKINNY_ROWS, device=x.device)
        counter = torch.zeros(tiles, dtype=torch.int32, device=x.device)

        def call(w8, ws=ws, counter=counter):
            _build.check(lib.icikit_quant_matvec_split(
                1, x.data_ptr(), w8.data_ptr(), scale.data_ptr(),
                out.data_ptr(), rows, n, k, ws.data_ptr(),
                counter.data_ptr(), splits, st), "quant_matvec")
        return call
    entry = lib.icikit_quant_matvec
    entry.argtypes, entry.restype = _ROW_ENTRY, ctypes.c_int
    return lambda w8: _build.check(entry(
        1, x.data_ptr(), w8.data_ptr(), scale.data_ptr(), out.data_ptr(),
        rows, n, k, st), "quant_matvec")


def run_shape(libs, tag, gen, rows: int = ROWS) -> dict:
    """One shape's record."""
    from icikit_torch.bench.stream_ab import (copies_past_l2, device_ms,
                                              rotating)
    from icikit_torch.ops.cuda_quant import quant_matvec_plain, skinny_splits

    n, k = SHAPES[tag]
    x = torch.randn((rows, k), generator=gen, device="cuda").to(
        torch.bfloat16)
    w8s = [torch.randint(-127, 128, (n, k), generator=gen, device="cuda",
                         dtype=torch.int8) for _ in range(copies_past_l2(n * k))]
    scale = torch.rand((n,), generator=gen, device="cuda") / 127
    outs = {a: torch.empty((rows, n), device="cuda") for a in "AB"}
    fns = {a: rotating(matvec_call(libs[a][0], x, scale, outs[a]), w8s)
           for a in "AB"}
    ms = {a: [] for a in "AB"}
    for a in "ABBA":
        ms[a].append(device_ms(fns[a], ITERS))
    # the check: each arm on the first copy against the plain version
    want = quant_matvec_plain(x, w8s[0], scale)
    top = float(want.abs().max())
    errs, again = {}, None
    for a in "AB":
        call = matvec_call(libs[a][0], x, scale, outs[a])
        call(w8s[0])
        errs[a] = float((outs[a] - want).abs().max()) / top
        if a == "B":
            first = outs[a].clone()
            call(w8s[0])
            again = bool(torch.equal(first, outs[a]))
    sweep = {}
    for s in SPLIT_SWEEP:
        if valid_splits(k, s, rows):
            sweep[s] = device_ms(rotating(matvec_call(
                libs["B"][0], x, scale, outs["B"], splits=s), w8s), ITERS)
    one = torch.zeros(1, device="cuda")
    floor_ms = device_ms(lambda: one.add_(1.0), ITERS)
    s16 = scale.to(torch.bfloat16)
    try:
        lib_ms = device_ms(rotating(lambda w: torch._weight_int8pack_mm(
            x, w, s16), w8s), ITERS)
    except (RuntimeError, NotImplementedError) as exc:
        lib_ms, lib_why = None, f"{type(exc).__name__}: {exc}"[:160]
    else:
        lib_why = "torch._weight_int8pack_mm (bf16 out)"
    del w8s
    w16s = [torch.randn((n, k), generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(copies_past_l2(2 * n * k))]
    mm_ms = device_ms(rotating(lambda w: torch.matmul(x, w.t()), w16s),
                      ITERS)
    del w16s
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    bnd, by = bound_ms(n, k, rows)
    rec = {"kernel": "qmv_bf16_skinny", "shape": tag, "n": n, "k": k,
           "rows": rows,
           "splits_b": skinny_splits(rows, k),
           "turns": "A B B A", "ms": ms, "splits_sweep_ms_b": sweep,
           "empty_launch_ms": floor_ms,
           "bound_ms": bnd, "bound_by": by, "library_ms": lib_ms,
           "library": lib_why, "cublas_bf16_ms": mm_ms,
           "rel_err_vs_plain": errs, "b_repeats_bitwise": again,
           "tolerance": TOL}
    rec["ok"] = errs["A"] <= TOL and errs["B"] <= TOL and again
    return rec


def prefill_call(lib, x, w8, scale, out):
    """One source's bf16 matvec at rows > 16 into ``out``, a no-argument
    call (the tile kernel ignores the split arguments)."""
    rows, k = x.shape
    n = out.shape[1]
    st = torch.cuda.current_stream().cuda_stream
    return lambda: _build.check(lib.icikit_quant_matvec_split(
        1, x.data_ptr(), w8.data_ptr(), scale.data_ptr(), out.data_ptr(),
        rows, n, k, None, None, 1, st), "quant_matvec")


def report(libs, src_a: str, src_b: str) -> None:
    """The run's last lines: ptxas's registers and spills of both
    sources, and the card's name and power limit."""
    print(json.dumps({"registers_spill_bytes": {
        n: libs[n][1] for n in "AB"}, "sources": {"A": src_a, "B": src_b}}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip())


def run_prefill_shape(libs, tag, gen, rows: int = PREFILL_ROWS) -> dict:
    """One prefill shape's record."""
    from icikit_torch.bench.flash_ab import event_ms
    from icikit_torch.ops.cuda_quant import quant_matvec_plain

    n, k = SHAPES[tag]
    x = torch.randn((rows, k), generator=gen, device="cuda").to(
        torch.bfloat16)
    w8 = torch.randint(-127, 128, (n, k), generator=gen, device="cuda",
                       dtype=torch.int8)
    scale = torch.rand((n,), generator=gen, device="cuda") / 127
    outs = {a: torch.empty((rows, n), device="cuda") for a in "AB"}
    fns = {a: prefill_call(libs[a][0], x, w8, scale, outs[a]) for a in "AB"}
    ms = {a: [] for a in "AB"}
    for a in "ABBA":
        ms[a].append(event_ms(fns[a], PREFILL_ITERS))
    want = quant_matvec_plain(x, w8, scale)
    top = float(want.abs().max())
    errs = {}
    for a in "AB":
        fns[a]()
        errs[a] = float((outs[a] - want).abs().max()) / top
    first = outs["B"].clone()
    fns["B"]()
    again = bool(torch.equal(first, outs["B"]))
    s16 = scale.to(torch.bfloat16)
    try:
        lib_ms = event_ms(lambda: torch._weight_int8pack_mm(x, w8, s16), 3)
    except (RuntimeError, NotImplementedError) as exc:
        lib_ms, lib_why = None, f"{type(exc).__name__}: {exc}"[:160]
    else:
        lib_why = "torch._weight_int8pack_mm (bf16 out)"
    w16 = w8.to(torch.bfloat16)
    mm_ms = event_ms(lambda: torch.matmul(x, w16.t()), PREFILL_ITERS)
    del w16, want, first
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    bnd, by = bound_ms(n, k, rows)
    rec = {"kernel": "qmv_bf16_tile", "shape": tag, "n": n, "k": k,
           "rows": rows, "turns": "A B B A", "ms": ms, "bound_ms": bnd,
           "bound_by": by, "library_ms": lib_ms, "library": lib_why,
           "cublas_bf16_ms": mm_ms, "rel_err_vs_plain": errs,
           "b_repeats_bitwise": again, "tolerance": TOL}
    rec["ok"] = errs["A"] <= TOL and errs["B"] <= TOL and again
    return rec


def run_prefill(src_a: str, src_b: str, shapes=PREFILL_SHAPES,
                seed: int = 13) -> bool:
    """Time and check both sources' tile kernel at the prefill's rows;
    whether every record held."""
    libs = build({"A": src_a, "B": src_b})
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ok, means, recs = True, {"A": {}, "B": {}}, {}
    for tag in shapes:
        rec = recs[tag] = run_prefill_shape(libs, tag, gen)
        print(json.dumps(rec), flush=True)
        ok &= rec["ok"]
        for a in "AB":
            means[a][tag] = sum(rec["ms"][a]) / len(rec["ms"][a])
    if set(shapes) == set(PREFILL_SHAPES):
        print(json.dumps({
            "layer_ms": {a: layer_ms(means[a]) for a in "AB"},
            "generate_ms": {a: LAYERS * layer_ms(means[a]) for a in "AB"},
            "launches_a_generate": LAYERS * len(PREFILL_SHAPES),
            "bound_layer_ms": layer_ms({s: recs[s]["bound_ms"]
                                        for s in shapes}),
            "cublas_bf16_layer_ms": layer_ms({s: recs[s]["cublas_bf16_ms"]
                                              for s in shapes})}))
    report(libs, src_a, src_b)
    return ok


def run(src_a: str, src_b: str, shapes=tuple(SHAPES), seed: int = 12) -> bool:
    """Time and check both sources; whether every record held."""
    libs = build({"A": src_a, "B": src_b})
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ok, means = True, {"A": {}, "B": {}}
    for tag in shapes:
        rec = run_shape(libs, tag, gen)
        print(json.dumps(rec), flush=True)
        ok &= rec["ok"]
        for a in "AB":
            means[a][tag] = sum(rec["ms"][a]) / len(rec["ms"][a])
    if set(shapes) == set(SHAPES):
        print(json.dumps({"step_ms": {a: step_ms(means[a]) for a in "AB"},
                          "per_step": PER_STEP,
                          "bound_step_ms": step_ms({
                              s: bound_ms(*SHAPES[s])[0] for s in SHAPES})}))
    report(libs, src_a, src_b)
    return ok


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--a", required=True, help="quant.cu of arm A")
    p.add_argument("--b", required=True, help="quant.cu of arm B")
    p.add_argument("--shapes", default=None,
                   help="of " + ", ".join(SHAPES) + " (at --rows 4096: of "
                   + ", ".join(PREFILL_SHAPES) + "; the default: all)")
    p.add_argument("--rows", type=int, default=ROWS,
                   choices=(ROWS, PREFILL_ROWS),
                   help="the step's rows (the skinny kernel) or the "
                        "prefill's (the tile kernel)")
    p.add_argument("--timing-only", action="store_true",
                   help="exit 0 even where an output departs")
    args = p.parse_args(argv)
    known = PREFILL_SHAPES if args.rows == PREFILL_ROWS else tuple(SHAPES)
    shapes = tuple(args.shapes.split(",")) if args.shapes else known
    bad = [s for s in shapes if s not in known]
    if bad:
        p.error(f"unknown shapes at rows {args.rows}: {bad}")
    for src in (args.a, args.b):
        if not os.path.isfile(src):
            p.error(f"no such source: {src}")
    if not torch.cuda.is_available():
        raise SystemExit("quant_ab needs a CUDA card")
    ok = (run_prefill if args.rows == PREFILL_ROWS else run)(
        args.a, args.b, shapes)
    return 0 if ok or args.timing_only else 1


if __name__ == "__main__":
    raise SystemExit(main())
