"""Where a sort's time goes: every kernel launch of the network, timed.

Runs the local-sort schedule of 2^log2n int32 keys on the card pass by
pass, with a CUDA event between launches, and prints one JSON line per
geometry: each pass's kind, shape and median milliseconds over 5
sorts, the sums by kind, and the memory-bandwidth bound of
the launches (2 * n * 4 bytes each at the card's nameplate).

``--profile N`` adds one line from a ``torch.profiler`` trace of N
back-to-back calls of the port's ``sort`` (p = 1): device time by
kernel name and the device's busy and idle share.

    python -m icikit_torch.bench.passes --log2n 28
    python -m icikit_torch.bench.passes --log2n 28 --t-grid 12,13,14
    python -m icikit_torch.bench.passes --log2n 28 --profile 3
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import tempfile
import time

import torch


def time_schedule(log2n: int, t_grid: int, t_big: int, g_max: int,
                  reps: int = 5, seed: int = 0) -> dict:
    from icikit_torch.bench.headline import device_identity, make_keys
    from icikit_torch.bench.sort import hbm_nameplate_bytes
    from icikit_torch.ops import cuda_sort as cs
    from icikit_torch.utils.timing import _median

    n = 1 << log2n
    plan = cs.sort_schedule(n, t_grid, t_big, g_max)
    keys = make_keys(n, "cuda", seed)
    buf = torch.empty_like(keys)
    per_pass = [[] for _ in plan]
    totals = []
    for rep in range(reps + 1):
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(len(plan) + 1)]
        events[0].record()
        cur = keys
        for i, step in enumerate(plan):
            if step[0] == "net":
                cur = cs.net_pass(cur, step[1], step[2], out=buf)
            else:
                cur = cs.cross_pass(cur, *step[1:], out=buf)
            events[i + 1].record()
        torch.cuda.synchronize()
        if rep == 0:  # warm-up
            if not torch.equal(buf, torch.sort(keys).values):
                raise AssertionError("schedule did not sort")
            continue
        for i in range(len(plan)):
            per_pass[i].append(events[i].elapsed_time(events[i + 1]))
        totals.append(events[0].elapsed_time(events[-1]))
    rows, by_kind = [], {}
    for step, ts in zip(plan, per_pass):
        ms = _median(ts)
        if step[0] == "net":
            kind = "net_sort" if step[2][0][0] == 1 else "net_round"
            shape = {"tile": step[1],
                     "stages": sum(len(s) for _, s in step[2])}
        else:
            kind = "cross"
            shape = {"span": step[1], "bits": [step[3], step[4]]}
        rows.append({"kind": kind, **shape, "ms": ms})
        by_kind.setdefault(kind, [0, 0.0])
        by_kind[kind][0] += 1
        by_kind[kind][1] += ms
    bw = hbm_nameplate_bytes()
    name, power = device_identity("cuda")
    return {
        "log2n": log2n, "t_grid": t_grid, "t_big": t_big, "g_max": g_max,
        "launches": len(plan), "median_total_ms": _median(totals),
        "by_kind": {k: {"launches": c, "ms": t}
                    for k, (c, t) in by_kind.items()},
        "bound_ms": (len(plan) * 2 * n * 4 / bw * 1e3) if bw else None,
        "passes": rows, "device": name, "power_limit": power,
    }


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union_us(spans) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def profile_sort(log2n: int, sorts: int = 3, seed: int = 0) -> dict:
    """Device activity over ``sorts`` back-to-back ``sort`` calls (p = 1)
    from a ``torch.profiler`` chrome trace: device milliseconds by
    kernel name, the busy time (union of kernel, copy and set
    intervals), and the idle share of the device span (first device
    event to last) and of the host's wall time (first call to the final
    synchronise, profiler overhead included)."""
    from torch.profiler import ProfilerActivity, profile

    from icikit_torch.bench.headline import device_identity, make_keys
    from icikit_torch.models.sort import sort
    from icikit_torch.utils.mesh import make_mesh

    mesh = make_mesh(1, device="cuda")
    keys = make_keys(1 << log2n, "cuda", seed)
    sort(keys, mesh)  # the build and the allocator's first blocks
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(sorts):
            sort(keys, mesh)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    dev = [e for e in events
           if e.get("cat") in _DEVICE_CATS and "dur" in e]
    by_name: dict = {}
    for e in dev:
        # "void (anonymous namespace)::net_kernel<int>(...)" -> net_kernel
        key = re.match(r"(?:void )?([\w:]*)", e["name"].replace(
            "(anonymous namespace)::", "")).group(1).split("::")[-1]
        c, t = by_name.get(key, (0, 0.0))
        by_name[key] = (c + 1, t + e["dur"])
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in dev]
    busy = _union_us(spans)
    span = (max(e for _, e in spans) - min(s for s, _ in spans)
            if spans else 0.0)
    name, power = device_identity("cuda")
    return {
        "profile": {"log2n": log2n, "sorts": sorts,
                    "device_events": len(dev),
                    "by_name": {k: {"count": c, "ms": t / 1e3}
                                for k, (c, t) in sorted(by_name.items())},
                    "busy_ms": busy / 1e3, "device_span_ms": span / 1e3,
                    "host_wall_ms": wall_us / 1e3,
                    "idle_share_of_span": (1 - busy / span) if span
                    else None,
                    "idle_share_of_wall": 1 - busy / wall_us},
        "device": name, "power_limit": power,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log2n", type=int, default=28)
    ap.add_argument("--t-grid", default="13",
                    help="comma-separated log2 tile sizes (T_BIG = tile)")
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="also trace N sort calls with torch.profiler")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("passes: needs a CUDA device", file=sys.stderr)
        return 1
    from icikit_torch.ops import cuda_sort as cs
    for lt in (int(v) for v in args.t_grid.split(",")):
        print(json.dumps(time_schedule(args.log2n, 1 << lt, 1 << lt,
                                       cs.G_MAX)), flush=True)
    if args.profile:
        print(json.dumps(profile_sort(args.log2n, args.profile)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
