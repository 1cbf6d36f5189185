"""The bf16 flash kernels of two ``attention.cu`` sources, timed in turns
on one card.

Builds each source with ``nvcc`` (for ``sm_90a``, ``-Xptxas -v``)
through ``ops._build`` into its own library under
``icikit_torch/build/ab/``, named by a hash of the source and the flags
(a second run on the same source loads it), then, at each shape,
times the kernels of source A, B, B, A by CUDA events over back-to-back
launches on the same tensors, beside one PyTorch call for the same
function (``library_ms``) and the function's bound. The shapes are the
paths' own, bf16 and causal:

- ``--kernels fwd``: ``flash_fwd`` online at the decode prefill's
  (8, 8, 512, 128) (B3) and the long-context (1, 4, 131072, 128), in
  constant-shift mode (shift 16) at the train step's (8, 8, 1024, 128)
  (B5-shift) and its many-block (1, 8, 2048, 128) (B4); the library is
  causal SDPA's forward.
- ``--kernels bwd``: ``flash_bwd`` at (8, 8, 1024, 128) (B6) and
  (1, 8, 2048, 128) (B7), ``flash_bwd_dq`` and ``flash_bwd_dkv`` at
  (1, 4, 131072, 128) (B8); the library is SDPA's backward through
  autograd; ``flash_bwd``'s time includes zeroing its float32 dq buffer,
  as the wrapper does.

B's outputs are held to A's: relative L2 in every 64-row block within
1e-2, and the forward's lse within 1e-3 absolute (``chip_smoke.py``'s
bf16 BLOCK_L2_TOL and FLASH_TOL). A record that departs carries
``"ok": false`` and the run exits 1, unless ``--timing-only``. Bounds:
each input read and each output written once at 3.35 TB/s against the
causal products (two in the forward, five in the backward) at 989
TFLOP/s, the larger. Prints one
JSON line a shape, then the kernels' registers and spills as ptxas
reported them, and the card's name and power limit. Needs a CUDA card.

    python -m icikit_torch.bench.flash_ab --a OLD.cu \\
        --b icikit_torch/csrc/attention.cu --kernels fwd,bwd
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess

import torch

from icikit_torch.ops import _build

LOG2E = 1.4426950408889634
SHIFT = 16.0
MEM_BPS = 3.35e12          # H100 SXM HBM3, NVIDIA's data sheet
BF16_TENSOR_OPS = 989e12   # dense bf16, the same
# (b, h, s, d) and, for the forward, the constant shift (None: online)
FWD_SHAPES = {"B3": ((8, 8, 512, 128), None),
              "B5-shift": ((8, 8, 1024, 128), SHIFT),
              "B4": ((1, 8, 2048, 128), SHIFT),
              "long": ((1, 4, 131072, 128), None)}
BWD_SHAPES = {"B6": (8, 8, 1024, 128), "B7": (1, 8, 2048, 128),
              "B8": (1, 4, 131072, 128)}
KERNELS = ("fwd", "bwd")
# B against A, in bf16: relative L2 in each BLOCK_ROWS-row block of every
# output, and the forward's lse absolute
BLOCK_ROWS = 64
TOL = {"block_rel_l2": 1e-2, "lse": 1e-3}


def bound_ms(kernels: str, bhsd) -> tuple:
    """(ms, "bytes" or "operations"): the least time the card could take
    for the causal function at (b, h, s, d)."""
    b, h, s, d = bhsd
    pairs = b * h * s * (s + 1) // 2
    if kernels == "fwd":      # q, k, v in; out and lse out; QK^T, PV
        nbytes, ops = 4 * b * h * s * d * 2 + b * h * s * 4, 2 * 2 * d * pairs
    else:                     # q, k, v, out, do, lse, delta in; dq, dk, dv
        nbytes = 7 * b * h * s * d * 2 + 2 * b * h * s * 4
        ops = 5 * 2 * d * pairs
    t_b, t_o = nbytes / MEM_BPS, ops / BF16_TENSOR_OPS
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def _ptxas_regs(log: str, keep=None) -> dict:
    """{kernel: (registers, spill bytes)} of the kernels whose mangled
    name ``keep`` accepts (by default the bf16 flash kernels), from
    nvcc's ``-Xptxas -v`` output."""
    keep = keep or (lambda name: "flash_" in name and "f32" not in name)
    lines = log.splitlines()
    regs = {}
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if not m or not keep(m.group(1)):
            continue
        fn = subprocess.run(["c++filt", m.group(1)], capture_output=True,
                            text=True).stdout.strip()
        info = " ".join(lines[i + 1:i + 4])
        r = re.search(r"Used (\d+) registers", info)
        sp = re.search(r"(\d+) bytes spill stores", info)
        name = fn.replace("(anonymous namespace)::", "").replace("void ", "")
        regs[name.split("(")[0]] = (int(r.group(1)) if r else None,
                                    int(sp.group(1)) if sp else None)
    return regs


def build(sources: dict) -> dict:
    """{name: (library, registers)}, the sources compiled in parallel."""
    built = _build.build_sources("attention", sources,
                                 os.path.join(_build.BUILD_DIR, "ab"),
                                 ("-Xptxas", "-v"))
    return {n: (lib, _ptxas_regs(log)) for n, (lib, log) in built.items()}


def event_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def fwd_calls(lib, q, k, v, shift, outs):
    """The forward of one source at one shape, a no-argument call."""
    b, h, s, d = q.shape
    out, lse = outs
    st = torch.cuda.current_stream().cuda_stream
    args = [1, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b * h, s, s, d, 1, d ** -0.5 * LOG2E,
            int(shift is not None), 0.0 if shift is None else shift, st]
    return {"flash_fwd": lambda: _build.check(lib.icikit_flash_fwd(*args),
                                              "flash_fwd")}


def bwd_calls(lib, tag, q, k, v, do, lse, delta, outs):
    """The launches of one source at one shape: flash_bwd (B6, B7) or
    flash_bwd_dq then flash_bwd_dkv (B8), each a no-argument call."""
    b, h, s, d = q.shape
    scale = d ** -0.5
    st = torch.cuda.current_stream().cuda_stream
    common = [1, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              lse.data_ptr(), delta.data_ptr()]
    tail = [b * h, s, s, d, 1, scale * LOG2E, scale, st]
    dq, dk, dv = outs
    if tag != "B8":
        def bwd():
            dq.zero_()
            _build.check(lib.icikit_flash_bwd(
                *common, dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                *tail), "flash_bwd")
        return {"flash_bwd": bwd}
    return {"flash_bwd_dq": lambda: _build.check(lib.icikit_flash_bwd_dq(
                *common, dq.data_ptr(), *tail), "flash_bwd_dq"),
            "flash_bwd_dkv": lambda: _build.check(lib.icikit_flash_bwd_dkv(
                *common, dk.data_ptr(), dv.data_ptr(), *tail),
                "flash_bwd_dkv")}


def _turns(fns, iters):
    """{source: {kernel: [ms, ms]}} timed A, B, B, A."""
    ms = {n: {kern: [] for kern in fns[n]} for n in "AB"}
    for n in "ABBA":
        for kern, fn in fns[n].items():
            ms[n][kern].append(event_ms(fn, iters))
    for n in "BA":
        for fn in fns[n].values():
            fn()
    torch.cuda.synchronize()
    return ms


def _rel(x, y) -> float:
    return float((x.float() - y.float()).abs().max()
                 / y.float().abs().max().clamp_min(1e-30))


def block_rel_l2(x, y) -> float:
    """The largest ||x - y|| / ||y|| over the BLOCK_ROWS-row blocks of
    (b, h, s, d) tensors, in float64."""
    x, y = (t.double().unflatten(2, (-1, BLOCK_ROWS)) for t in (x, y))
    num = (x - y).square().sum((-2, -1)).sqrt()
    den = y.square().sum((-2, -1)).sqrt().clamp_min(1e-300)
    return float((num / den).max())


def run_fwd(libs, shapes, gen) -> bool:
    """One record a shape; whether B's outputs held to A's at all."""
    import torch.nn.functional as F

    ok = True
    for tag in shapes:
        (b, h, s, d), shift = FWD_SHAPES[tag]
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        outs = {n: (torch.empty_like(q),
                    torch.empty((b, h, s), device="cuda")) for n in "AB"}
        fns = {n: fwd_calls(libs[n][0], q, k, v, shift, outs[n])
               for n in "AB"}
        iters = 3 if s > 100_000 else 50
        bnd, by = bound_ms("fwd", (b, h, s, d))
        rec = {"kernels": "fwd", "shape": tag, "bhsd": [b, h, s, d],
               "shift": shift, "turns": "A B B A",
               "ms": _turns(fns, iters),
               "b_vs_a": {"out_rel_err": _rel(outs["B"][0], outs["A"][0]),
                          "out_block_rel_l2": block_rel_l2(outs["B"][0],
                                                           outs["A"][0]),
                          "lse_abs_err": float((outs["B"][1] - outs["A"][1])
                                               .abs().max())},
               "bound_ms": bnd, "bound_by": by,
               "library": "causal SDPA forward"}
        rec["ok"] = (rec["b_vs_a"]["out_block_rel_l2"] <= TOL["block_rel_l2"]
                     and rec["b_vs_a"]["lse_abs_err"] <= TOL["lse"])
        rec["library_ms"] = event_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=d ** -0.5), iters)
        print(json.dumps(rec), flush=True)
        ok &= rec["ok"]
        del q, k, v, outs, fns
        torch.cuda.empty_cache()
    return ok


def run_bwd(libs, shapes, gen) -> bool:
    """One record a shape; whether B's outputs held to A's at all."""
    import torch.nn.functional as F

    from icikit_torch.ops import cuda_attention as ca

    ok = True
    for tag in shapes:
        b, h, s, d = BWD_SHAPES[tag]
        q, k, v, do = (torch.randn((b, h, s, d), generator=gen,
                                   device="cuda").to(torch.bfloat16)
                       for _ in range(4))
        out, lse = ca.flash_fwd(q, k, v, True, d ** -0.5)
        delta = (do.float() * out.float()).sum(-1)
        del out
        outs = {n: (torch.zeros(q.shape, dtype=torch.float32
                                if tag != "B8" else torch.bfloat16,
                                device="cuda"),
                    torch.empty_like(k), torch.empty_like(v)) for n in "AB"}
        fns = {n: bwd_calls(libs[n][0], tag, q, k, v, do, lse, delta,
                            outs[n]) for n in "AB"}
        iters = 3 if s > 100_000 else 20
        bnd, by = bound_ms("bwd", (b, h, s, d))
        rec = {"kernels": "bwd", "shape": tag, "bhsd": [b, h, s, d],
               "turns": "A B B A", "ms": _turns(fns, iters),
               "b_vs_a_rel_err": [_rel(x, y) for x, y in
                                  zip(outs["B"], outs["A"])],
               "b_vs_a_block_rel_l2": [block_rel_l2(x, y) for x, y in
                                       zip(outs["B"], outs["A"])],
               "bound_ms": bnd, "bound_by": by,
               "library": "SDPA's backward through autograd"}
        lq, lk, lv = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True,
                                            scale=d ** -0.5)
        rec["library_ms"] = event_ms(lambda: torch.autograd.grad(
            lo, (lq, lk, lv), do, retain_graph=True), iters)
        rec["ok"] = max(rec["b_vs_a_block_rel_l2"]) <= TOL["block_rel_l2"]
        print(json.dumps(rec), flush=True)
        ok &= rec["ok"]
        del q, k, v, do, lse, delta, outs, fns, lq, lk, lv, lo
        torch.cuda.empty_cache()
    return ok


def run(src_a: str, src_b: str, kernels=KERNELS, fwd_shapes=None,
        bwd_shapes=None, seed: int = 8) -> bool:
    """Time and compare the two sources; whether B's outputs held to A's
    at every shape."""
    libs = build({"A": src_a, "B": src_b})
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ok = True
    if "fwd" in kernels:
        ok &= run_fwd(libs, fwd_shapes or tuple(FWD_SHAPES), gen)
    if "bwd" in kernels:
        ok &= run_bwd(libs, bwd_shapes or tuple(BWD_SHAPES), gen)
    print(json.dumps({"registers_spill_bytes": {
        n: libs[n][1] for n in "AB"}, "sources": {"A": src_a, "B": src_b}}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip())
    return ok


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--a", required=True, help="attention.cu of arm A")
    p.add_argument("--b", required=True, help="attention.cu of arm B")
    p.add_argument("--kernels", default=",".join(KERNELS),
                   help="of " + ", ".join(KERNELS))
    p.add_argument("--fwd-shapes", default=",".join(FWD_SHAPES),
                   help="of " + ", ".join(FWD_SHAPES))
    p.add_argument("--bwd-shapes", default=",".join(BWD_SHAPES),
                   help="of " + ", ".join(BWD_SHAPES))
    p.add_argument("--timing-only", action="store_true",
                   help="exit 0 even where B's outputs depart from A's")
    args = p.parse_args(argv)
    kernels = tuple(args.kernels.split(","))
    fwd_shapes = tuple(args.fwd_shapes.split(","))
    bwd_shapes = tuple(args.bwd_shapes.split(","))
    bad = ([k for k in kernels if k not in KERNELS]
           + [s for s in fwd_shapes if s not in FWD_SHAPES]
           + [s for s in bwd_shapes if s not in BWD_SHAPES])
    if bad:
        p.error(f"unknown kernels or shapes: {bad}")
    if not torch.cuda.is_available():
        raise SystemExit("flash_ab needs a CUDA card")
    ok = run(args.a, args.b, kernels, fwd_shapes, bwd_shapes)
    return 0 if ok or args.timing_only else 1


if __name__ == "__main__":
    raise SystemExit(main())
