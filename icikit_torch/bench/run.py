"""CLI entry point for the collective benchmark harness.

Usage (the p ranks of the mesh on the card):

    python -m icikit_torch.bench.run --family allreduce --sizes 1048576 \\
        --dtype float32

``--simulate`` runs the same ranks on the CPU instead. One process sweeps
every variant of a family and prints the table, with the records as
JSON lines where ``--json`` asks (each JAX's record and ``processes``).
``--processes k`` splits the ranks across k OS processes
(``bench/procs.py``; process 0 prints and writes).
The exit code is 1 when any record fails its verification.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys


def main(argv=None):
    from icikit_torch.bench import procs
    from icikit_torch.bench.harness import FAMILIES

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--family", default="allgather", choices=FAMILIES)
    ap.add_argument("--algorithms", default=None,
                    help="comma-separated variant names (default: all)")
    ap.add_argument("--sizes", default=None,
                    help="comma-separated block sizes in elements "
                         "(default: the reference sweep 2^0..2^16 step 2^4)")
    ap.add_argument("--devices", type=int, default=8,
                    help="ranks of the mesh (default 8, JAX's simulated "
                         "mesh and a v4-8's devices)")
    ap.add_argument("--simulate", action="store_true",
                    help="run the ranks on the CPU instead of the card")
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--dtype", default="int32")
    ap.add_argument("--checked", action="store_true",
                    help="time the checksum-carrying schedules "
                         "(icikit_torch.parallel.integrity): every "
                         "exchange verified on the device, the integrity "
                         "overhead's A/B rows (hand-rolled variants "
                         "only; 'xla' is skipped)")
    ap.add_argument("--json", dest="json_path", default=None,
                    help="append records as JSON lines to this path")
    ap.add_argument("--profile", dest="profile_dir", default=None,
                    help="write a torch.profiler trace of the sweep into "
                         "this directory")
    procs.add_process_args(ap)
    args = ap.parse_args(argv)
    if args.json_path:
        from icikit_torch.bench.outputs import check_output
        check_output(args.json_path)
    rc = procs.relaunch(args, "icikit_torch.bench.run", procs.argv_of(argv))
    if rc is not None:
        return rc

    import torch

    from icikit_torch.bench.harness import (
        CHECKED_FAMILIES,
        REFERENCE_SWEEP,
        REFERENCE_SWEEP_PERSONALIZED,
        format_table,
        sweep_family,
    )
    from icikit_torch.utils.mesh import make_mesh

    if args.checked and args.family not in CHECKED_FAMILIES:
        ap.error(f"--checked covers {CHECKED_FAMILIES}, "
                 f"not --family {args.family}")
    if not args.simulate and not torch.cuda.is_available():
        print("no CUDA device: pass --simulate to run the ranks on the CPU",
              file=sys.stderr)
        return 2
    proc, _ = procs.join(args)
    mesh = make_mesh(args.devices, device="cpu" if args.simulate else "cuda")
    sizes = (tuple(int(s) for s in args.sizes.split(","))
             if args.sizes else
             (REFERENCE_SWEEP_PERSONALIZED if args.family == "alltoall"
              else REFERENCE_SWEEP))
    algorithms = args.algorithms.split(",") if args.algorithms else None
    profiled = contextlib.nullcontext()
    if args.profile_dir:
        from torch.profiler import (ProfilerActivity, profile,
                                    tensorboard_trace_handler)
        acts = [ProfilerActivity.CPU]
        if not args.simulate:
            acts.append(ProfilerActivity.CUDA)
        profiled = profile(activities=acts, on_trace_ready=(
            tensorboard_trace_handler(args.profile_dir)))
    with profiled:
        records = sweep_family(mesh, args.family, algorithms, sizes=sizes,
                               dtype=getattr(torch, args.dtype),
                               runs=args.runs, warmup=args.warmup,
                               checked=args.checked)
    procs.leave()
    if proc == 0:
        print(format_table(records))
    if args.json_path and proc == 0:
        # append: record files accumulate across invocations; a line is
        # JAX's record and the process count
        with open(args.json_path, "a") as f:
            for r in records:
                f.write(json.dumps({**json.loads(r.to_json()),
                                    "processes": args.processes}) + "\n")
    if not all(r.verified for r in records):
        print("VERIFICATION FAILURES present", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
