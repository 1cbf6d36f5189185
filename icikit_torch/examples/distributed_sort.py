"""The reference's Parallel-Sorting program as library API: generate a
p-invariant input, sort it four ways across the ranks, verify each with
the inversion counter, and sort key-value pairs.

Run on the card (8 ranks), or with ``--device cpu``::

    python -m icikit_torch.examples.distributed_sort
"""

from __future__ import annotations

import argparse
import sys

import torch

from icikit_torch.models.sort import (SORT_ALGORITHMS, check_sort, sort,
                                      sort_kv)
from icikit_torch.utils.mesh import make_mesh
from icikit_torch.utils.prandom import uniform_global


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--log2n", type=int, default=16)
    args = ap.parse_args(argv)
    p, n = args.ranks, 1 << args.log2n
    mesh = make_mesh(p, device=args.device)
    keys = (uniform_global(0, n, odd_dist=True, device=args.device)
            * 1e9).to(torch.int32)

    for alg in SORT_ALGORITHMS:
        out = sort(keys, mesh, algorithm=alg)
        errors = int((out[1:] < out[:-1]).sum())
        print(f"{alg:>15}: sorted {n} keys, {errors} inversions")
        assert errors == 0

    # the reference's distributed verifier, on block-sharded data
    blocks = sort(keys, mesh).reshape(p, n // p)
    print("check_sort errors:", check_sort(blocks, mesh))

    # key-value sorting (beyond the reference: payloads follow their keys)
    vals = torch.arange(n, dtype=torch.int32, device=args.device)
    _, sv = sort_kv(keys, vals, mesh)
    assert torch.equal(sv.long(), torch.argsort(keys, stable=True))
    print("sort_kv: values follow keys (stable)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
