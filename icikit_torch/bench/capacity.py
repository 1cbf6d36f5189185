"""Capacity overflow study: the minimal non-overflowing ``cap_factor``
per (algorithm, p, n, distribution).

The port of ``icikit/bench/capacity.py``. The reference over-allocates
every rank's working buffer to the full n (``Parallel-Sorting/src/
psort.cc:385``), so overflow cannot happen; the capacity-padded
exchanges make the trade explicit: a factor too small costs a retry, a
factor too large wastes device memory. For each configuration the study
runs the real rank-vectorised sort at ``cap = factor * n_loc / p``
(sample family) or ``factor * n_loc`` (quicksort) and reads the sort's
own overflow flag, the signal its retry keys on.

CLI (the ranks on the card unless ``--device cpu``)::

    python -m icikit_torch.bench.capacity --ns 20,22,24 --ps 4,8 \
        --out chiprun_out/capacity.json
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

FACTORS = (1.25, 1.5, 2.0, 3.0, 4.0, 6.0)
ALGS = ("sample[allgather]", "sample[bitonic]", "quicksort")


def _keys(n: int, dist: str, device: str) -> torch.Tensor:
    """The study's int32 keys: ``uniform_global(7, n)`` (skewed for
    ``dist == "odd"``) spread over [-1e9, 1e9)."""
    from icikit_torch.utils.prandom import uniform_global
    u = uniform_global(7, n, odd_dist=(dist == "odd"), device=device)
    return (u * 2e9 - 1e9).to(torch.int32)


def overflowed(alg: str, x2d: torch.Tensor, n_loc: int, p: int,
               factor: float) -> bool:
    """Did ``alg`` at ``factor`` overflow its capacity on ``x2d`` (p,
    n_loc)?"""
    from icikit_torch.models.sort.quicksort import hypercube_quicksort_shard
    from icikit_torch.models.sort.sample import sample_sort_shard
    if alg == "quicksort":
        _, ovf = hypercube_quicksort_shard(x2d, p, max(1, int(factor * n_loc)))
        return int(ovf.sum()) > 0
    splitter = "bitonic" if alg == "sample[bitonic]" else "allgather"
    cap = max(1, min(n_loc, int(factor * n_loc / p)))
    _, ovf = sample_sort_shard(x2d, p, cap, splitter)
    return int(ovf.sum()) > 0


def run_study(ns, ps, dists=("uniform", "odd"), factors=FACTORS,
              algs=ALGS, device: str = "cuda", log=print):
    records = []
    for p in ps:
        for n_log in ns:
            n = 1 << n_log
            n_loc = n // p
            for dist in dists:
                x2d = _keys(n, dist, device).reshape(p, n_loc)
                for alg in algs:
                    found = next((f for f in factors
                                  if not overflowed(alg, x2d, n_loc, p, f)),
                                 None)
                    records.append({"alg": alg, "p": p, "n": n_log,
                                    "dist": dist, "min_factor": found})
                    log(f"p={p} n=2^{n_log} {dist:8s} {alg:18s} "
                        f"min_factor={found}")
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ns", default="20,22,24",
                    help="log2 global sizes, comma-separated")
    ap.add_argument("--ps", default="4,8")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="write the records here")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        print("no CUDA device: pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 2
    records = run_study([int(x) for x in args.ns.split(",")],
                        [int(x) for x in args.ps.split(",")],
                        device=args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f)
        print(f"wrote {len(records)} records to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
