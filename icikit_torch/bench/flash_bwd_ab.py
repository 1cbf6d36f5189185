"""The bf16 flash backward kernels of two ``attention.cu`` sources, timed
in turns on one card.

Builds each source with ``nvcc`` (for ``sm_90a``, ``-Xptxas -v``) into
its own library under ``icikit_torch/build/ab/``, then, at each shape,
times the backward of source A, B, B, A by CUDA events over back-to-back
launches on the same tensors, beside SDPA's backward through autograd
(``library_ms``). The shapes are the paths' own: ``flash_bwd`` at the
train step's (8, 8, 1024, 128) (B6) and its many-block (1, 8, 2048, 128)
(B7), ``flash_bwd_dq`` and ``flash_bwd_dkv`` at the long-context
(1, 4, 131072, 128) (B8); bf16, causal. Each source's outputs are held
to the first's (relative to the largest entry); ``flash_bwd``'s time
includes zeroing its float32 dq buffer, as the wrapper does. Prints one
JSON line a shape, then the kernels' registers and spills as ptxas
reported them, and the card's name and power limit. Needs a CUDA card.

    python -m icikit_torch.bench.flash_bwd_ab --a OLD.cu \\
        --b icikit_torch/csrc/attention.cu
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess

import torch

from icikit_torch.ops import _build

LOG2E = 1.4426950408889634
SHAPES = {"B6": (8, 8, 1024, 128), "B7": (1, 8, 2048, 128),
          "B8": (1, 4, 131072, 128)}


def build(name: str, src: str) -> tuple:
    """(library, {kernel: (registers, spill bytes)}) of one source."""
    out_dir = os.path.join(_build.BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, f"lib{name}.so")
    res = subprocess.run(
        [_build.nvcc_path(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", so, src],
        capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stdout}"
                           f"{res.stderr}")
    regs, lines = {}, (res.stdout + res.stderr).splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if not m or "flash_bwd" not in m.group(1) or "f32" in m.group(1):
            continue
        fn = subprocess.run(["c++filt", m.group(1)], capture_output=True,
                            text=True).stdout.strip()
        info = " ".join(lines[i + 1:i + 4])
        r = re.search(r"Used (\d+) registers", info)
        sp = re.search(r"(\d+) bytes spill stores", info)
        regs[fn.split("(__nv")[0].replace("(anonymous namespace)::", "")
             .replace("void ", "")] = (int(r.group(1)) if r else None,
                                       int(sp.group(1)) if sp else None)
    lib = ctypes.CDLL(so)
    for fn, argtypes in _build._SIGNATURES["attention"].items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    return lib, regs


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


def calls(lib, tag, q, k, v, do, lse, delta, outs):
    """The launches of one source at one shape: flash_bwd (B6, B7) or
    flash_bwd_dq then flash_bwd_dkv (B8), each a no-argument call."""
    b, h, s, d = q.shape
    scale = d ** -0.5
    st = torch.cuda.current_stream().cuda_stream
    common = [1, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              lse.data_ptr(), delta.data_ptr()]
    tail = [b * h, s, s, d, 1, scale * LOG2E, scale, st]
    if tag != "B8":
        dq, dk, dv = outs

        def bwd():
            dq.zero_()
            _build.check(lib.icikit_flash_bwd(
                *common, dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                *tail), "flash_bwd")
        return {"flash_bwd": bwd}
    dq, dk, dv = outs
    return {"flash_bwd_dq": lambda: _build.check(lib.icikit_flash_bwd_dq(
                *common, dq.data_ptr(), *tail), "flash_bwd_dq"),
            "flash_bwd_dkv": lambda: _build.check(lib.icikit_flash_bwd_dkv(
                *common, dk.data_ptr(), dv.data_ptr(), *tail),
                "flash_bwd_dkv")}


def run(src_a: str, src_b: str, shapes=tuple(SHAPES), seed: int = 8):
    import torch.nn.functional as F

    from icikit_torch.ops import cuda_attention as ca

    libs = dict(zip("AB", (build("ab_a", src_a), build("ab_b", src_b))))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for tag in shapes:
        b, h, s, d = SHAPES[tag]
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
        fns = {n: calls(libs[n][0], tag, q, k, v, do, lse, delta, outs[n])
               for n in "AB"}
        iters = 3 if s > 100_000 else 20
        rec = {"shape": tag, "bhsd": [b, h, s, d], "turns": "A B B A",
               "ms": {n: {kern: [] for kern in fns[n]} for n in "AB"}}
        for n in "ABBA":
            for kern, fn in fns[n].items():
                rec["ms"][n][kern].append(event_ms(fn, iters))
        for fn in fns["B"].values():
            fn()
        for fn in fns["A"].values():
            fn()
        torch.cuda.synchronize()
        rec["b_vs_a_rel_err"] = [
            float((x.float() - y.float()).abs().max()
                  / y.float().abs().max().clamp_min(1e-30))
            for x, y in zip(outs["B"], outs["A"])]
        lq, lk, lv = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True,
                                            scale=d ** -0.5)
        rec["library_ms"] = event_ms(lambda: torch.autograd.grad(
            lo, (lq, lk, lv), do, retain_graph=True), iters)
        print(json.dumps(rec), flush=True)
        del q, k, v, do, lse, delta, outs, fns, lq, lk, lv, lo
        torch.cuda.empty_cache()
    print(json.dumps({"registers_spill_bytes": {
        n: libs[n][1] for n in "AB"}, "sources": {"A": src_a, "B": src_b}}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--a", required=True, help="attention.cu of arm A")
    p.add_argument("--b", required=True, help="attention.cu of arm B")
    p.add_argument("--shapes", default=",".join(SHAPES),
                   help="of " + ", ".join(SHAPES))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_ab needs a CUDA card")
    run(args.a, args.b, tuple(args.shapes.split(",")))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
