"""The CLI of the dynamic-load-balancing study, on the card.

The port of ``icikit/models/solitaire/run.py``. The reference's binary
takes an input dataset and an output file and prints "found N
solutions" plus the wall time
(``Dynamic-Load-Balancing/src/main.cc:135,213-214``). This CLI does
the same, plus the comparison the reference could only do by eyeballing
cluster runs: it times static vs dynamic scheduling on the same dataset
and reports per-worker load (games, DFS nodes) and the imbalance ratio.
A worker is a CUDA stream of the card (``--workers``, default 8), or of
the CPU with ``--device cpu``.

    # solve a generated dataset with both schedulers on 8 workers
    python -m icikit_torch.models.solitaire.run --grade hard --games 256

    # reference-format dataset in, solutions out
    python -m icikit_torch.models.solitaire.run --input games.dat \
        --output sol.txt

Exit code 1 when the schedulers disagree, 2 without a card (unless
``--device cpu``).
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--input", default=None,
                    help="reference-format dataset (.dat or .dat.gz); "
                         "default: generate one")
    ap.add_argument("--output", default=None,
                    help="write solution renderings to this file")
    ap.add_argument("--games", type=int, default=256)
    ap.add_argument("--grade", default="easy",
                    choices=["easy", "medium", "hard"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk-size", type=int, default=8,
                    help="games per dynamic-schedule chunk "
                         "(reference chunk_size=8, main.cc:15)")
    ap.add_argument("--strategy", default="both",
                    choices=["static", "dynamic", "host", "all", "both"],
                    help="'host' = native C++ thread-pool backend; "
                         "'both' = static+dynamic on devices; 'all' adds "
                         "host")
    ap.add_argument("--max-steps", type=int, default=2_000_000_000,
                    help="per-board DFS node budget (step-limit analog of "
                         "the reference's per-run watchdog)")
    ap.add_argument("--watchdog", type=int, default=None,
                    help="arm a whole-run watchdog alarm of N seconds "
                         "(0 = off; default: ICIKIT_WATCHDOG_S when "
                         "set, else off; reference chopsigs_, "
                         "utilities.cc:49-58)")
    ap.add_argument("--checkpoint", default=None,
                    help="chunk-level checkpoint file for the dynamic "
                         "scheduler: completed chunks stream here and a "
                         "restarted run resumes, solving only what is "
                         "missing (upgrade over the reference's "
                         "accidental crash-survival, SURVEY.md §5.4)")
    ap.add_argument("--json", dest="json_path", default=None)
    ap.add_argument("--workers", type=int, default=8,
                    help="scheduler workers, each a stream of --device")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        print("no CUDA device: pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 2

    from icikit_torch.utils.guard import chopsigs, disarm, resolve_watchdog_s
    wd = resolve_watchdog_s(args.watchdog)
    if wd:
        chopsigs(wd)
        try:
            return _guarded_main(args)
        finally:
            # success or failure, the caller's process must not keep
            # the hard-exit trap handler or a ticking alarm
            disarm()
    return _guarded_main(args)


def _guarded_main(args):
    from icikit_torch.models.solitaire.dataset import (generate_dataset,
                                                       load_dataset)
    from icikit_torch.models.solitaire.scheduler import (
        solve_dynamic,
        solve_host,
        solve_static,
        write_solutions,
    )

    if args.input:
        batch = load_dataset(args.input)
        src = args.input
    else:
        batch = generate_dataset(args.games, args.grade, seed=args.seed)
        src = f"generated({args.games} games, {args.grade}, seed={args.seed})"
    print(f"dataset: {src} -> {len(batch)} games")

    devices = [args.device] * args.workers
    reports = []
    if args.strategy in ("static", "both", "all"):
        reports.append(solve_static(batch, devices=devices,
                                    max_steps=args.max_steps))
    if args.strategy in ("dynamic", "both", "all"):
        reports.append(solve_dynamic(batch, devices=devices,
                                     chunk_size=args.chunk_size,
                                     max_steps=args.max_steps,
                                     checkpoint_path=args.checkpoint))
    if args.strategy in ("host", "all"):
        reports.append(solve_host(batch, chunk_size=args.chunk_size,
                                  max_steps=args.max_steps))

    records = []
    for rep in reports:
        print(f"[{rep.strategy}] found {rep.n_solutions} solutions "
              f"in {rep.wall_s:.3f} s  "
              f"(imbalance {rep.imbalance:.2f}, "
              f"per-worker games {rep.per_worker_games}, "
              f"per-worker nodes {rep.per_worker_steps})")
        records.append({
            "strategy": rep.strategy,
            "n_games": len(batch),
            "n_solutions": rep.n_solutions,
            "wall_s": rep.wall_s,
            "imbalance": rep.imbalance,
            "per_worker_games": rep.per_worker_games,
            "per_worker_steps": rep.per_worker_steps,
            "total_nodes": int(rep.steps.sum()),
        })

    counts = {r["n_solutions"] for r in records}
    if len(counts) > 1:
        print("ERROR: schedulers disagree on solution count", file=sys.stderr)
        return 1

    if args.output and reports:
        n = write_solutions(args.output, batch, reports[-1])
        print(f"wrote {n} solutions to {args.output}")
    if args.json_path:
        with open(args.json_path, "w") as f:
            for r in records:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
