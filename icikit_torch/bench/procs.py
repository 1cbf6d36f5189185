"""``--processes k`` for the bench CLIs: a sweep whose p ranks split
across k OS processes, the ``mpirun -np k`` analog of a scale point.

A CLI given ``--processes k`` (k > 1) and no ``--process-id`` starts k
copies of itself on a fresh coordinator port
(``parallel.multihost.launch_processes``) and waits for them; each copy
joins the ``torch.distributed`` group (gloo) and builds its mesh across
the processes (``utils.mesh.make_mesh``), process i holding ranks
``[i p/k, (i + 1) p/k)``. Every process runs the sweep; process 0
prints the table and writes the records, each carrying ``processes``.
"""

from __future__ import annotations

import datetime
import os
import sys
import tempfile

import torch
import torch.distributed as dist

from icikit_torch.parallel import transport


def add_process_args(ap) -> None:
    ap.add_argument("--processes", type=int, default=1,
                    help="split the ranks across this many OS processes "
                         "(gloo; the mpirun -np analog)")
    ap.add_argument("--process-id", type=int, default=None,
                    help="this worker's index (set by the launcher)")
    ap.add_argument("--port", type=int, default=None,
                    help="the coordinator's port (set by the launcher)")
    ap.add_argument("--process-timeout", type=float, default=600.0,
                    help="seconds the processes wait for each other")


def relaunch(args, module: str, argv: list) -> int | None:
    """As the launcher (``--processes k > 1``, no ``--process-id``):
    run k workers of ``module`` with ``argv`` and return the exit code
    (the largest of the workers'), after printing process 0's output
    (and every worker's on a failure). None as a worker or with one
    process."""
    if args.processes <= 1 or args.process_id is not None:
        return None
    from icikit_torch.parallel.multihost import launch_processes

    with tempfile.TemporaryDirectory(prefix="icikit_procs_") as out:
        res = launch_processes(module, argv, args.processes, out,
                               args.process_timeout + 60)
    codes = [c for c, _ in res]
    for i, (code, text) in enumerate(res):
        if i == 0 or any(codes):
            print(f"-- process {i}: exit {code}\n{text}", end="")
    return max(codes, key=abs)


def join(args) -> tuple[int, int]:
    """As a worker: join the group (or stay alone with one process);
    returns (this process's index, the process count)."""
    if args.processes <= 1:
        return 0, 1
    from icikit_torch.parallel.multihost import init_distributed

    # the host's cores shared out: k processes of a full thread pool
    # each oversubscribe the host many times over
    torch.set_num_threads(max(1, min(torch.get_num_threads(),
                                     len(os.sched_getaffinity(0))
                                     // args.processes)))
    init_distributed(
        coordinator_address=f"localhost:{args.port}",
        num_processes=args.processes, process_id=args.process_id,
        timeout=datetime.timedelta(seconds=args.process_timeout))
    return args.process_id, args.processes


def leave() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def sync(device) -> None:
    """Wait for the card, then for every process: a timed window starts
    with all processes ready (``examples/multihost._sync``)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    if dist.is_initialized():
        dist.barrier()


def gather_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every process's rows of ``t`` (this process's ranks as dim 0),
    concatenated in rank order; ``t`` itself in one process."""
    view = transport.mesh_view(mesh, mesh.axis_name)
    return t if view is None else view.all_gather(t)


def all_true(flag: bool, mesh) -> bool:
    """``flag`` on every process (one process: ``flag``)."""
    view = transport.mesh_view(mesh, mesh.axis_name)
    if view is None:
        return flag
    return bool(view.all_reduce(torch.tensor([int(flag)]), "min"))


def argv_of(ap_argv) -> list:
    """The CLI's own arguments, to hand to its workers."""
    return list(sys.argv[1:] if ap_argv is None else ap_argv)
