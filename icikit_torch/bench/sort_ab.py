"""The sort's two kernels from two ``bitonic_net.cu`` sources, timed in
turns on one card.

Builds ``bitonic_net.cu`` from each of two source directories with
``nvcc`` (for ``sm_90a``, ``-Xptxas -v``) through
``ops._build.build_sources`` into ``icikit_torch/build/ab/`` (named by a
hash of the source and the flags), then runs each source's whole sort of
2^log2n int32 keys at its own geometry (``--geom-a``, ``--geom-b``:
log2 of t_grid, log2 of t_big, g_max and the split of a round's cross
stages, ``even`` or ``greedy``; ``ops.cuda_sort.sort_schedule``'s plan;
A's default is the design before the Hopper redesign: 13,13,9,greedy)
in turns A, B, B, A, ``--reps`` sorts a turn after one untimed
sort. A CUDA event is recorded between every two launches, so each
launch and the sort whole (the first event to the last) are timed on
the device. The first launch reads the keys and writes a second buffer;
the others run in place on it, as ``run_schedule`` does.

B's sort is held bit for bit to A's and to ``torch.sort``; a departure
marks the summary ``"ok": false`` and exits 1 unless ``--timing-only``.
A source without ``icikit_cross_log2cb`` (the design before the Hopper
redesign) takes K2 blocks of ``min(tile, max(32, 2^14 / 2^G))`` columns,
as its wrapper chose them.

Prints one JSON line a turn (the sort's ms), then one a source: its
launches, summed ms and bounds by kind (``net_sort``: the in-tile sort;
``net_round``: the other K1 launches; ``cross``: K2), the sort's
median, the kernels' registers and spill bytes from ptxas; then the
yardsticks (``torch.sort`` of the keys; ``torch.sort(x.view(-1, T),
dim=-1)`` at each side's tile T, the nearest library call to the in-tile
sort but not the same function, since every row is sorted ascending; a
1 GiB ``copy_``) and the card's name and power limit. Bounds: each
launch reads and writes the array once at 3.35 TB/s (``bytes``); the
in-tile sort's min/max pairs (n / 2 a stage, two int32 instructions
each) at 64 int32 lanes an SM a clock, 132 SMs, 1.98 GHz
(``int32_issue``). Needs a CUDA card.

    python -m icikit_torch.bench.sort_ab --a OLD_DIR \\
        --b icikit_torch/csrc --geom-a 13,13,9,greedy --geom-b 14,14,10
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess

import torch

from icikit_torch.ops import _build
from icikit_torch.ops import cuda_sort as cs

MEM_BPS = 3.35e12              # H100 SXM HBM3, NVIDIA's data sheet
INT32_LANES_PER_SM = 64        # Hopper white paper: int32 units an SM
SMS, BOOST_HZ = 132, 1.98e9    # H100 SXM


def kind_of(step) -> str:
    """The kind of a ``sort_schedule`` step: the in-tile sort (its first
    round has direction bit 1), another K1 launch, or K2."""
    if step[0] == "cross":
        return "cross"
    return "net_sort" if step[2][0][0] == 1 else "net_round"


def stages_of(step) -> int:
    """Compare-exchange stages of a step, each over every key."""
    if step[0] == "cross":
        return step[4] - step[3] + 1
    return sum(len(s) for _, s in step[2])


def bytes_ms(n: int, launches: int = 1) -> float:
    """One read and one write of n int32 keys a launch at MEM_BPS."""
    return launches * 2 * n * 4 / MEM_BPS * 1e3


def int32_issue_ms(n: int, stages: int) -> float:
    """n / 2 min/max pairs a stage, two int32 instructions each, at the
    card's int32 issue rate."""
    return n * stages / (INT32_LANES_PER_SM * SMS * BOOST_HZ) * 1e3


def log2cb(lib, tile: int, g: int) -> int:
    """K2's block columns (log2) for a pass of g bits, as the source's
    own wrapper chose them."""
    if hasattr(lib, "icikit_cross_log2cb"):
        return lib.icikit_cross_log2cb(g)
    return cs.ilog2(min(tile, max(32, (1 << 14) >> g)))


def greedy(plan, g_max: int) -> list:
    """``plan`` with each round's cross stages regrouped as the reference
    and the design before the Hopper redesign grouped them: each pass
    filled to g_max bits from the top."""
    out, i = [], 0
    while i < len(plan):
        if plan[i][0] != "cross":
            out.append(plan[i])
            i += 1
            continue
        j = i
        while j < len(plan) and plan[j][0] == "cross" and \
                plan[j][1] == plan[i][1]:
            j += 1
        _, span, tile, _, top, mo = plan[i]
        lo_all = plan[j - 1][3]
        for hi in range(top, lo_all - 1, -g_max):
            out.append(("cross", span, tile, max(lo_all, hi - g_max + 1),
                        hi, mo))
        i = j
    return out


def plan_calls(lib, keys: torch.Tensor, buf: torch.Tensor, plan) -> list:
    """The plan's launches on ``lib`` as no-argument calls: the first
    from keys into buf, the rest in place on buf."""
    calls = []
    n = keys.numel()
    for i, step in enumerate(plan):
        src = keys if i == 0 else buf
        st = torch.cuda.current_stream().cuda_stream
        if step[0] == "net":
            db, hi, lo = cs.round_arrays(step[2])
            args = (0, src.data_ptr(), buf.data_ptr(), n, cs.ilog2(step[1]),
                    len(step[2]), db, hi, lo, st)
            calls.append(lambda a=args: _build.check(
                lib.icikit_net_pass(*a), "net_pass"))
        else:
            _, span, tile, lo_bit, hi_bit, mo = step
            args = (0, src.data_ptr(), buf.data_ptr(), n, span,
                    cs.ilog2(tile), lo_bit, hi_bit,
                    log2cb(lib, tile, hi_bit - lo_bit + 1), int(mo), st)
            calls.append(lambda a=args: _build.check(
                lib.icikit_cross_pass(*a), "cross_pass"))
    return calls


def timed_sort(calls) -> list:
    """Run the calls once with an event between every two launches;
    [ms of each launch]."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(calls) + 1)]
    ev[0].record()
    for c, e in zip(calls, ev[1:]):
        c()
        e.record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]


def by_kind(plan, launch_ms, n: int) -> dict:
    """Launches, summed ms and bounds by kind, from one ms a launch."""
    out = {}
    for step, ms in zip(plan, launch_ms):
        k = out.setdefault(kind_of(step), {"launches": 0, "ms": 0.0,
                                           "stages": 0})
        k["launches"] += 1
        k["ms"] += ms
        k["stages"] += stages_of(step)
    for k in out.values():
        k["bytes_bound_ms"] = bytes_ms(n, k["launches"])
        k["int32_issue_ms"] = int32_issue_ms(n, k["stages"])
    return out


def build(a_dir: str, b_dir: str) -> dict:
    """{"A"/"B": (library, {kernel: (registers, spill bytes)})}."""
    from icikit_torch.bench.flash_ab import _ptxas_regs

    built = _build.build_sources(
        "bitonic_net", {n: os.path.join(d, "bitonic_net.cu")
                        for n, d in (("A", a_dir), ("B", b_dir))},
        os.path.join(_build.BUILD_DIR, "ab"), ("-Xptxas", "-v"))
    return {n: (lib, _ptxas_regs(log, lambda name: "_kernel" in name))
            for n, (lib, log) in built.items()}


def run(a_dir: str, b_dir: str, geoms: dict, log2n: int = 28, reps: int = 3,
        seed: int = 0) -> bool:
    """Time and compare the two sources; whether B's sort equals A's and
    torch.sort's bit for bit."""
    from icikit_torch.bench.flash_ab import event_ms
    from icikit_torch.bench.headline import make_keys
    from icikit_torch.utils.timing import _median

    libs = build(a_dir, b_dir)
    n = 1 << log2n
    keys = make_keys(n, "cuda", seed)
    bufs = {s: torch.empty_like(keys) for s in "AB"}
    plans = {}
    for s in "AB":
        plan = cs.sort_schedule(n, 1 << geoms[s][0], 1 << geoms[s][1],
                                geoms[s][2])
        plans[s] = greedy(plan, geoms[s][2]) if geoms[s][3] == "greedy" \
            else plan
    calls = {s: plan_calls(libs[s][0], keys, bufs[s], plans[s]) for s in "AB"}
    per_launch = {s: [[] for _ in plans[s]] for s in "AB"}
    totals = {s: [] for s in "AB"}
    for turn, s in enumerate("ABBA"):
        timed_sort(calls[s])  # untimed: the first launch's set-up
        for _ in range(reps):
            ms = timed_sort(calls[s])
            for i, t in enumerate(ms):
                per_launch[s][i].append(t)
            totals[s].append(sum(ms))
        print(json.dumps({"turn": turn, "source": s,
                          "sort_ms": totals[s][-reps:]}), flush=True)
    want = torch.sort(keys).values
    ok_b = bool(torch.equal(bufs["B"], bufs["A"]))
    ok_lib = {s: bool(torch.equal(bufs[s], want)) for s in "AB"}
    del want
    for s, d in (("A", a_dir), ("B", b_dir)):
        med = [_median(ts) for ts in per_launch[s]]
        print(json.dumps({
            "source": s, "dir": d, "log2n": log2n,
            "geometry": dict(zip(("log2_t_grid", "log2_t_big", "g_max",
                                  "split"), geoms[s])),
            "launches": len(plans[s]), "sort_ms_median": _median(totals[s]),
            "sort_ms": totals[s], "bytes_bound_ms": bytes_ms(n, len(plans[s])),
            "by_kind": by_kind(plans[s], med, n),
            "first_launch_ms": med[0], "launch_ms": med,
            "equal_to_torch_sort": ok_lib[s],
            "registers_spill_bytes": libs[s][1]}), flush=True)
    dst = torch.empty_like(keys)
    yard = {"torch.sort": event_ms(lambda: torch.sort(keys), 3),
            "copy_1GiB_ms" if log2n == 28 else "copy_ms":
                event_ms(lambda: dst.copy_(keys), 10)}
    for s in "AB":
        t = 1 << geoms[s][0]
        yard[f"torch.sort(x.view(-1, {t}), dim=-1)"] = event_ms(
            lambda t=t: torch.sort(keys.view(-1, t), dim=-1), 3)
    ok = ok_b and all(ok_lib.values())
    print(json.dumps({"yardsticks_ms": yard, "b_equal_to_a": ok_b,
                      "ok": ok}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)
    return ok


def _geom(text: str) -> tuple:
    """``"t,b,g[,split]"``: log2 t_grid, log2 t_big, g_max, split."""
    parts = text.split(",")
    split = parts[3] if len(parts) == 4 else "even"
    if len(parts) not in (3, 4) or split not in ("even", "greedy"):
        raise argparse.ArgumentTypeError(f"bad geometry {text!r}")
    return int(parts[0]), int(parts[1]), int(parts[2]), split


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--a", required=True,
                   help="directory of arm A's bitonic_net.cu")
    p.add_argument("--b", required=True, help="the same for arm B")
    p.add_argument("--geom-a", type=_geom, default=(13, 13, 9, "greedy"),
                   help="log2 t_grid, log2 t_big, g_max[, split] of A's "
                        "schedule")
    p.add_argument("--geom-b", type=_geom,
                   default=(cs.ilog2(cs.T_GRID), cs.ilog2(cs.T_BIG),
                            cs.G_MAX, "even"),
                   help="the same for B (default: the package's)")
    p.add_argument("--log2n", type=int, default=28)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--timing-only", action="store_true",
                   help="exit 0 even where a sort departs")
    args = p.parse_args(argv)
    missing = [os.path.join(d, "bitonic_net.cu") for d in (args.a, args.b)
               if not os.path.isfile(os.path.join(d, "bitonic_net.cu"))]
    if missing:
        p.error(f"missing sources: {missing}")
    if not torch.cuda.is_available():
        raise SystemExit("sort_ab needs a CUDA card")
    ok = run(args.a, args.b, {"A": args.geom_a, "B": args.geom_b},
             args.log2n, args.reps)
    return 0 if ok or args.timing_only else 1


if __name__ == "__main__":
    raise SystemExit(main())
