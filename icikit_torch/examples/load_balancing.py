"""The reference's Dynamic-Load-Balancing study as library API: solve a
graded batch of peg-solitaire boards with static and dynamic scheduling
and compare per-worker load.

Run on the card (8 workers, each a stream), or with ``--device cpu``
(and a small ``--max-steps``: the CPU takes the plain solver)::

    python -m icikit_torch.examples.load_balancing
"""

from __future__ import annotations

import argparse
import sys

from icikit_torch.models.solitaire.dataset import generate_dataset
from icikit_torch.models.solitaire.scheduler import (solve_dynamic,
                                                     solve_static)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--max-steps", type=int, default=200_000)
    args = ap.parse_args(argv)
    batch = generate_dataset(64, grade="hard", seed=0)
    counts = set()
    for solve in (solve_static, solve_dynamic):
        rep = solve(batch, devices=[args.device] * args.workers,
                    max_steps=args.max_steps)
        counts.add(rep.n_solutions)
        print(f"[{rep.strategy}] {rep.n_solutions} solutions in "
              f"{rep.wall_s:.2f} s — imbalance {rep.imbalance:.2f}, "
              f"per-worker nodes {rep.per_worker_steps}")
    return 0 if len(counts) == 1 else 1


if __name__ == "__main__":
    sys.exit(main())
