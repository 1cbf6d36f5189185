"""The reference's Communication study in a few lines of the port's API:
the twin of ``examples/collectives_study.py``.

Every registered allgather and alltoall schedule beside the vendor
baseline, at p = 8 ranks on the card (``--device cpu`` puts the same
ranks on the CPU), each record verified against the reference's
closed-form pattern. The equivalent CLI is ``python -m
icikit_torch.bench.run``.

Run: ``python -m icikit_torch.examples.collectives_study [--device cpu]``
"""

from __future__ import annotations

import argparse
import sys


def study(device: str = "cuda", p: int = 8, sizes=(256, 4096),
          runs: int = 3) -> list:
    """The study's records (``bench.harness.BenchRecord``), every one
    verified."""
    from icikit_torch.bench.harness import sweep_family
    from icikit_torch.utils.mesh import make_mesh

    mesh = make_mesh(p, device=device)
    records = []
    for family in ("allgather", "alltoall"):
        records += sweep_family(mesh, family, sizes=sizes, runs=runs,
                                warmup=1)
    if not all(r.verified for r in records):
        raise AssertionError("pattern oracle failed: "
                             f"{[r for r in records if not r.verified]}")
    return records


def main(argv=None) -> int:
    from icikit_torch.bench.harness import format_table

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(format_table(study(args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
