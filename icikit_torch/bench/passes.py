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
import sys

import torch


def time_schedule(log2n: int, t_grid: int, t_big: int, g_max: int,
                  reps: int = 5, seed: int = 0) -> dict:
    from icikit_torch.bench.headline import device_identity, make_keys
    from icikit_torch.bench.sort import hbm_nameplate_bytes
    from icikit_torch.bench.sort_ab import (by_kind, kind_of, plan_calls,
                                            timed_sort)
    from icikit_torch.ops import _build
    from icikit_torch.ops import cuda_sort as cs
    from icikit_torch.utils.timing import _median

    n = 1 << log2n
    plan = cs.sort_schedule(n, t_grid, t_big, g_max)
    keys = make_keys(n, "cuda", seed)
    buf = torch.empty_like(keys)
    calls = plan_calls(_build.load("bitonic_net"), keys, buf, plan)
    timed_sort(calls)  # warm-up
    if not torch.equal(buf, torch.sort(keys).values):
        raise AssertionError("schedule did not sort")
    runs = [timed_sort(calls) for _ in range(reps)]
    per_pass = [_median(ts) for ts in zip(*runs)]
    rows = []
    for step, ms in zip(plan, per_pass):
        if step[0] == "net":
            shape = {"tile": step[1],
                     "stages": sum(len(s) for _, s in step[2])}
        else:
            shape = {"span": step[1], "bits": [step[3], step[4]]}
        rows.append({"kind": kind_of(step), **shape, "ms": ms})
    bw = hbm_nameplate_bytes()
    name, power = device_identity("cuda")
    return {
        "log2n": log2n, "t_grid": t_grid, "t_big": t_big, "g_max": g_max,
        "launches": len(plan),
        "median_total_ms": _median([sum(ms) for ms in runs]),
        "by_kind": by_kind(plan, per_pass, n),
        "bound_ms": (len(plan) * 2 * n * 4 / bw * 1e3) if bw else None,
        "passes": rows, "device": name, "power_limit": power,
    }


def profile_sort(log2n: int, sorts: int = 3, seed: int = 0) -> dict:
    """Device activity over ``sorts`` back-to-back ``sort`` calls (p = 1)
    (``utils.trace.device_activity``): device milliseconds by kernel
    name, the busy time, and the idle share of the device span and of
    the host's wall time."""
    from icikit_torch.bench.headline import device_identity, make_keys
    from icikit_torch.models.sort import sort
    from icikit_torch.utils.mesh import make_mesh
    from icikit_torch.utils.trace import device_activity

    mesh = make_mesh(1, device="cuda")
    keys = make_keys(1 << log2n, "cuda", seed)
    sort(keys, mesh)  # the build and the allocator's first blocks
    torch.cuda.synchronize()

    def run():
        for _ in range(sorts):
            sort(keys, mesh)

    name, power = device_identity("cuda")
    return {"profile": {"log2n": log2n, "sorts": sorts,
                        **device_activity(run)},
            "device": name, "power_limit": power}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log2n", type=int, default=28)
    ap.add_argument("--t-grid", default="14",
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
