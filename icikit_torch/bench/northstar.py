"""North-star benchmark runner — every BASELINE.md target, one command.

The port of ``icikit/bench/northstar.py``, on the card: p ranks are
rank-vectorised on one device (``utils.mesh``) and the DLB study's p
workers are p CUDA streams of it (``models.solitaire.scheduler``). The
reference's studies ship as two PDFs of bitmap figures with no
machine-readable numbers (SURVEY.md §6); the targets (BASELINE.md) are
instead produced by this runner as one JSON-lines file + one markdown
report, with JAX's checks:

- **T1** allreduce bandwidth: every registered schedule vs the vendor
  baseline (the ``xla`` variant), float32[1M] (GB/s).
- **T2** broadcast + scatter/gather bandwidth sweep, 1 KB – 64 MB.
- **T3** bitonic sort throughput 2^20 – 2^28 int32; pass iff 2^28 keys
  sort in < 1 s (268.4 M keys/s).
- **T4** sample / sample-bitonic / quicksort at 2^24 int32.
- **T5** master/worker map: static vs dynamic chunking on graded
  datasets, schedulers agreeing on solution counts.

CLI::

    python -m icikit_torch.bench.northstar --out report.md   # the card
    python -m icikit_torch.bench.northstar --quick           # smoke-sized
    python -m icikit_torch.bench.northstar --quick --simulate  # the CPU

Exit code 1 when a check fails, 2 without a card (unless ``--simulate``
or ``--regen``).
"""

from __future__ import annotations

import os
import argparse
import json
import sys
import time


def run_northstar(mesh, quick: bool = False, runs: int = 4,
                  max_steps: int = 500_000):
    """Execute all targets on ``mesh``'s device (p ranks, p DLB
    workers); returns (coll_records, sort_records, dlb_records, checks)
    where checks is {name: bool}. ``max_steps`` is the DLB study's DFS
    node budget a board."""
    import torch

    from icikit_torch.bench.harness import sweep_family
    from icikit_torch.bench.sort import sweep_sorts
    from icikit_torch.models.solitaire.dataset import generate_dataset
    from icikit_torch.models.solitaire.scheduler import (solve_dynamic,
                                                         solve_static)
    from icikit_torch.utils.mesh import mesh_axis_size

    checks = {}
    on_card = torch.device(mesh.device).type == "cuda"
    workers = [mesh.device] * mesh_axis_size(mesh)

    # T1 — allreduce bandwidth at the north-star size
    t1_size = 1 << (14 if quick else 20)
    coll = sweep_family(mesh, "allreduce", sizes=(t1_size,),
                        dtype=torch.float32, runs=runs, warmup=1)

    # T2 — broadcast / scatter / gather, 1 KB – 64 MB (int32 elements)
    t2_sizes = ((256, 4096) if quick
                else (256, 4096, 65536, 1 << 20, 1 << 24))
    for fam in ("broadcast", "scatter", "gather"):
        coll += sweep_family(mesh, fam, sizes=t2_sizes, runs=runs,
                             warmup=1)
    expected_fams = {"allreduce", "broadcast", "scatter", "gather"}
    checks["collectives_verified"] = (
        {r.family for r in coll} == expected_fams
        and all(r.verified for r in coll))

    # T3 — bitonic sort throughput sweep up to the 2^28 goal.
    # Median-of-windows on the card only: on the CPU 3x the sweep time
    # buys nothing.
    sort_windows = 3 if on_card else 1
    t3_sizes = (1 << 14, 1 << 16) if quick else (1 << 20, 1 << 24, 1 << 28)
    sorts = sweep_sorts(mesh, t3_sizes, algorithms=("bitonic",),
                        runs=runs, warmup=1, windows=sort_windows)
    if not quick:
        # the headline target must actually have been measured: a mesh
        # constraint silently skipping bitonic (non-pow2 p) is a FAIL of
        # the target, not a vacuous pass
        goal = [r for r in sorts if r.n == 1 << 28]
        checks["bitonic_2e28_under_1s"] = bool(goal) and goal[0].best_s < 1.0
    # T4 — the other three algorithms at 2^24
    t4_sizes = ((1 << 14,) if quick else (1 << 24,))
    t4_algs = ("sample", "sample_bitonic", "quicksort")
    sorts += sweep_sorts(mesh, t4_sizes, algorithms=t4_algs, runs=runs,
                         warmup=1, windows=sort_windows)
    expected_algs = {"bitonic", *t4_algs}
    checks["sorts_verified"] = (
        {r.algorithm for r in sorts} == expected_algs
        and all(r.errors == 0 for r in sorts))

    # T5 — DLB static vs dynamic on graded datasets. The DFS node
    # budget is bounded (JAX's 500,000) so no single launch runs for
    # minutes; both strategies share the budget, so the agreement check
    # stays exact.
    dlb = []
    n_games = 64 if quick else 256
    for grade in ("easy", "hard"):
        batch = generate_dataset(n_games, grade, seed=0)
        for rep in (solve_static(batch, devices=workers,
                                 max_steps=max_steps),
                    solve_dynamic(batch, devices=workers,
                                  max_steps=max_steps)):
            dlb.append({
                "grade": grade, "strategy": rep.strategy,
                "n_games": n_games, "n_solutions": rep.n_solutions,
                "wall_s": rep.wall_s, "imbalance": rep.imbalance,
                # self-healing telemetry: nonzero deaths/reissues in a
                # bench row means the run recovered from real faults
                # (or an ICIKIT_CHAOS drill) rather than running clean
                "n_deaths": rep.n_deaths, "n_reissues": rep.n_reissues,
            })
    counts_agree = all(
        len({d["n_solutions"] for d in dlb if d["grade"] == g}) == 1
        for g in ("easy", "hard"))
    checks["dlb_schedulers_agree"] = counts_agree

    # T5b — the imbalance study proper: adversarially *placed* cost
    # skew (every hard board in the last static slice). Dynamic must
    # spread the expensive tail that static concentrates — the reason
    # the reference sub-repo exists (Dynamic-Load-Balancing/README.md:5).
    # Measured two ways: per-worker DFS-step imbalance on the workers
    # (machine-independent) and native thread-pool wall time,
    # where "static" = one contiguous chunk per thread and "dynamic" =
    # the reference's 8-game chunk queue on the same pool.
    from icikit_torch.models.solitaire.dataset import (
        generate_skewed_dataset)
    # The study needs pull granularity finer than the skew (chunks >>
    # workers): with one chunk per worker the queue degenerates to the
    # static assignment and there is nothing to balance. 256 games in
    # chunks of 4 (quick: 64 in chunks of 2) = 32+ pullable units, a
    # quarter of them hard.
    skewed = generate_skewed_dataset(64 if quick else 256, seed=3,
                                     hard_fraction=0.25)
    sk_chunk = 2 if quick else 4
    sk_static = solve_static(skewed, devices=workers, max_steps=max_steps)
    sk_dynamic = solve_dynamic(skewed, devices=workers, chunk_size=sk_chunk,
                               max_steps=max_steps)
    for rep in (sk_static, sk_dynamic):
        dlb.append({
            "grade": "skewed", "strategy": rep.strategy,
            "n_games": len(skewed), "n_solutions": rep.n_solutions,
            "wall_s": rep.wall_s, "imbalance": rep.imbalance,
            "n_deaths": rep.n_deaths, "n_reissues": rep.n_reissues,
        })
    try:
        n_cores = len(os.sched_getaffinity(0))
    except AttributeError:  # non-Linux
        n_cores = os.cpu_count() or 1
    n_threads = 8
    if not quick:  # host-native comparison: full runs only (the C++ build)
        from icikit_torch.models.solitaire.scheduler import solve_host
        host_static = solve_host(skewed, n_threads=n_threads,
                                 chunk_size=-(-len(skewed) // n_threads),
                                 max_steps=max_steps)
        host_dynamic = solve_host(skewed, n_threads=n_threads,
                                  max_steps=max_steps)
        for label, rep in (("host-static", host_static),
                           ("host-dynamic", host_dynamic)):
            dlb.append({
                "grade": "skewed", "strategy": label,
                "n_games": len(skewed), "n_solutions": rep.n_solutions,
                # the pool's board→worker map gives a real
                # per-worker split; on a host with fewer cores than
                # workers the DYNAMIC split still reflects OS
                # scheduling (the virtual-clock rows remain the
                # schedule-quality verdict), but static's is exact
                "wall_s": rep.wall_s, "imbalance": rep.imbalance,
            })
        if n_cores >= n_threads:
            # a wall-time comparison only carries signal when every
            # pool thread gets a core; on smaller hosts both
            # strategies measure total work plus scheduler noise
            checks["dlb_host_dynamic_wall_win"] = (
                host_dynamic.wall_s < host_static.wall_s)
    # Schedule quality is judged on the virtual-clock replay of the
    # exact per-board DFS costs (simulate_schedule): live-thread
    # telemetry on a host with fewer cores than workers measures the
    # OS scheduler, not the algorithm.
    from icikit_torch.models.solitaire.scheduler import simulate_schedule
    import numpy as _np
    sim_p = 8
    sim_st = simulate_schedule(sk_static.steps, sim_p, "static")
    sim_dy = simulate_schedule(sk_static.steps, sim_p, "dynamic",
                               chunk_size=sk_chunk)
    for label, per in (("modeled-static", sim_st),
                       ("modeled-dynamic", sim_dy)):
        arr = _np.asarray(per, _np.float64)
        dlb.append({
            "grade": "skewed", "strategy": label,
            "n_games": len(skewed), "n_solutions": sk_static.n_solutions,
            "wall_s": float(arr.max()) * 1e-9,  # see report note
            "imbalance": float(arr.max() / arr.mean()),
        })
    checks["dlb_dynamic_balances_skew"] = (
        max(sim_dy) / (sum(sim_dy) / sim_p)
        < max(sim_st) / (sum(sim_st) / sim_p))
    # the modeled win floor: the costliest single chunk bounds how low
    # the dynamic critical path can go, so small/quick sets cap out
    # around 2x; demand a clear (>25%) shortening rather than a fixed 2x
    checks["dlb_dynamic_critical_path_win"] = (
        max(sim_dy) < 0.75 * max(sim_st))
    return coll, sorts, dlb, checks


def render_markdown(coll, sorts, dlb, checks, meta) -> str:
    import dataclasses

    from icikit_torch.bench.report import render_report
    lines = ["# North-star benchmark results\n",
             f"- platform: **{meta['platform']}**, p = {meta['p']}",
             f"- device: {meta.get('device')}, power limit "
             f"{meta.get('power_limit')}",
             f"- date: {meta['date']}, wall time {meta['wall_s']:.0f} s",
             ""]
    lines.append("## Target checks\n")
    for name, ok in checks.items():
        lines.append(f"- {'PASS' if ok else 'FAIL'} — {name}")
    lines.append("\n## Sorting (keys/s)\n")
    if os.path.exists("docs/figs/sort_throughput.png"):
        lines.append("![throughput vs n](docs/figs/sort_throughput.png)\n")
    lines.append("| algorithm | n | median_ms | spread_ms | Mkeys/s "
                 "| errors | protocol |")
    lines.append("|---|---|---|---|---|---|---|")
    # Records accumulate across invocations. Headline protocol: each
    # cell shows the MOST RECENT median-of-windows record — never a
    # best-of across sessions, which keeps corrupted-fast windows as
    # "best recorded". Cells that only have chained-best records render
    # those, explicitly labeled; best-of readings stay in the jsonl. The
    # cell rule is report.select_headline's.
    from icikit_torch.bench.report import select_headline
    shown = select_headline(
        sorts, key_of=lambda r: (r.algorithm, r.n),
        proto_of=lambda r: getattr(r, "protocol", "chained-best"))
    for (alg, n) in sorted(shown, key=lambda k: (k[1], k[0])):
        r = shown[(alg, n)]
        errs = max(x.errors for x in sorts
                   if (x.algorithm, x.n) == (alg, n))
        if getattr(r, "protocol", "chained-best") == "median-of-windows":
            spread = f"[{r.min_s * 1e3:.1f}, {r.max_s * 1e3:.1f}]"
            proto = "median-of-windows"
            if getattr(r, "discarded", 0):
                proto += f" ({r.discarded} discarded)"
            if getattr(r, "suspect", False):
                proto += " SUSPECT"
            # session-stability stamp: escalation that never
            # converged marks the row's session as depressed/unstable
            q = getattr(r, "session_quality", None)
            q = q if isinstance(q, dict) else {}
            if q.get("degraded"):
                proto += " DEGRADED-SESSION"
            elif q.get("escalated"):
                proto += " (escalated)"
        else:
            spread = "—"
            proto = "chained-best"
        lines.append(f"| {r.algorithm} | 2^{r.n.bit_length() - 1} | "
                     f"{r.mean_s * 1e3:.2f} | {spread} | "
                     f"{r.keys_per_s / 1e6:.1f} | {errs} | {proto} |")
    if meta["p"] == 1:
        lines.append(
            "\n> **p=1 reading.** At one rank every distributed sort "
            "short-circuits to the same local sort kernels — the "
            "algorithm columns differ only in wrapper overhead. "
            "Algorithmic comparisons need p > 1 (project3.pdf §4's "
            "trends are about scaling, not one rank).\n")
    lines.append("\n## Dynamic load balancing\n")
    if meta["p"] == 1:
        lines.append(
            "> **Note:** with a single worker there is no imbalance to "
            "balance — the dynamic rows measure pure chunked-dispatch "
            "overhead. The static-vs-dynamic study needs workers "
            "(`--devices 8`: eight streams of the card).\n")
    if any(d["grade"] == "skewed" for d in dlb):
        lines.append(
            "> **Skewed study** (every hard board in the last static "
            "slice): `modeled-*` rows replay the exact per-board DFS "
            "costs through an 8-worker virtual clock "
            "(`simulate_schedule`) — schedule quality isolated from "
            "host thread-racing; their wall_s column is the modeled "
            "critical path in G-steps (steps × 1e-9), their imbalance "
            "max/mean steps. `host-*` rows run the native thread pool "
            "with static = one contiguous chunk per thread; wall-time "
            "differences only appear when the host has real cores. "
            "The modeled-vs-live consistency is an executable claim, "
            "not narration: the pool's board→worker telemetry must "
            "reproduce the modeled strategy ranking and per-worker "
            "load split (static within 5%, dynamic ordering within "
            "queue-racing margins) — `tests/test_solitaire.py::"
            "test_host_pool_reproduces_modeled_schedule_ranking`, "
            "on the same native solver the port copies.\n")
    lines.append("| grade | strategy | solutions | wall_s | imbalance |")
    lines.append("|---|---|---|---|---|")
    for d in dlb:
        imb = ("n/a" if d["imbalance"] is None
               else f"{d['imbalance']:.2f}")
        lines.append(f"| {d['grade']} | {d['strategy']} | "
                     f"{d['n_solutions']} | {d['wall_s']:.3f} | "
                     f"{imb} |")
    lines.append("")
    # render_report suppresses p=1 tables itself (identity programs);
    # the records stay in the JSON output either way
    lines.append(render_report(
        [r if isinstance(r, dict) else dataclasses.asdict(r)
         for r in coll],
        title="Collective families (best µs; busbw in JSON records)",
        heading_level=2))
    return "\n".join(lines)


def regen_from_jsonl(json_path: str) -> str:
    """Rebuild the markdown report from recorded results — no hardware
    re-run (the renderer changes more often than the measurements)."""
    import types
    coll, sorts, dlb, meta_rec = [], [], [], {}
    with open(json_path) as f:
        for line in f:
            r = json.loads(line)
            kind = r.pop("kind", None)
            if kind == "collective":
                coll.append(r)
            elif kind == "sort":
                sorts.append(types.SimpleNamespace(**r))
            elif kind == "dlb":
                dlb.append(r)
            elif kind == "checks":
                meta_rec = r
    if not meta_rec:
        raise ValueError(
            f"{json_path} has no checks/meta record — not a northstar "
            "records file (write one with `--json`)")
    meta = {k: meta_rec.pop(k, None)
            for k in ("platform", "p", "date", "wall_s", "device",
                      "power_limit")}
    return render_markdown(coll, sorts, dlb, meta_rec, meta)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true",
                    help="CI-sized problem sizes")
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--devices", type=int, default=8,
                    help="ranks of the mesh and DLB workers (default 8)")
    ap.add_argument("--simulate", action="store_true",
                    help="run the ranks and workers on the CPU")
    ap.add_argument("--out", default=None, help="markdown report path")
    ap.add_argument("--json", dest="json_path", default=None)
    ap.add_argument("--regen", default=None, metavar="JSONL",
                    help="re-render the markdown from recorded results "
                         "instead of running benchmarks")
    args = ap.parse_args(argv)

    if args.regen:
        md = regen_from_jsonl(args.regen)
        if args.out:
            with open(args.out, "w") as f:
                f.write(md)
            print(f"wrote {args.out}")
        else:
            print(md)
        return 0

    import torch

    if not args.simulate and not torch.cuda.is_available():
        print("no CUDA device: pass --simulate to run the ranks on the CPU",
              file=sys.stderr)
        return 2

    import dataclasses

    from icikit_torch.bench.headline import device_identity
    from icikit_torch.utils.mesh import make_mesh, mesh_axis_size

    device = "cpu" if args.simulate else "cuda"
    mesh = make_mesh(args.devices, device=device)
    t0 = time.time()
    coll, sorts, dlb, checks = run_northstar(mesh, quick=args.quick,
                                             runs=args.runs)
    name, power = device_identity(device)
    meta = {"platform": "cpu" if args.simulate else "gpu",
            "p": mesh_axis_size(mesh),
            "date": time.strftime("%Y-%m-%d %H:%M:%S"),
            "wall_s": time.time() - t0, "device": name,
            "power_limit": power}
    md = render_markdown(coll, sorts, dlb, checks, meta)
    if args.out:
        with open(args.out, "w") as f:
            f.write(md)
        print(f"wrote {args.out}")
    else:
        print(md)
    if args.json_path:
        # append: record files accumulate across invocations (the
        # studies' best-of protocol depends on it; "w" here once
        # destroyed committed records)
        from icikit_torch import obs
        with open(args.json_path, "a") as f:
            for r in coll:
                f.write(json.dumps(
                    {"kind": "collective", **dataclasses.asdict(r)}) + "\n")
            for r in sorts:
                f.write(json.dumps(
                    {"kind": "sort", **dataclasses.asdict(r)}) + "\n")
            for d in dlb:
                f.write(json.dumps({"kind": "dlb", **d}) + "\n")
            f.write(json.dumps({"kind": "checks", **checks,
                                **meta}) + "\n")
            # with the metrics registry armed, the run's metrics travel
            # with its records: reissue counts, pulls — the provenance a
            # bare wall_s column lacks
            snap = obs.metrics_snapshot()
            if snap is not None:
                f.write(json.dumps(obs.json_safe(
                    {"kind": "obs_metrics", **meta, **snap})) + "\n")
    for name, ok in checks.items():
        print(f"{'PASS' if ok else 'FAIL'} {name}")
    return 0 if all(checks.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
