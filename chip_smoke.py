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
6. kernels line: every ported kernel with its launches on the main path,
   its time at the main path's shapes, its plain version's time and its
   bound.

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
MULT = -1640531527


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60,
                       check=True)
    return q.stdout.strip().splitlines()[0]


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
    emit({"kernels": [
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
    ]})
    print(smi)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
