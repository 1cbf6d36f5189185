"""Multi-process bring-up and hybrid (DCN x ICI) meshes, rank-vectorised:
``icikit.parallel.multihost``'s layer for the port.

The reference's multi-node story is vendor MPI launched by PBS across
nodes (``Communication/Data/sub.sh:2,9-15``): one flat rank space, the
interconnect hidden behind MPI. JAX's layer brings up the multi-process
runtime (``jax.distributed``, the ``mpirun``/``MPI_Init`` analog) and
lays meshes out in two tiers, so that high-volume collectives ride the
fast tier (ICI) and only the minimum crosses the slow one (DCN). Here:

- :func:`init_distributed` — ``MPI_Init``:
  ``torch.distributed.init_process_group`` behind JAX's contract (a
  no-op in a single process with no cluster in the environment,
  idempotent, a raced double init counted as live).
- :func:`process_info` — ``MPI_Comm_rank``/``size`` at process level.
- :func:`launch_processes` — ``mpirun -np n`` on one host: n copies of a
  module's worker on a fresh coordinator port.
- :func:`make_hybrid_mesh` — a 2-D :class:`HybridMesh` (dcn, ici), flat
  rank ``s * p_ici + j``. In a multi-process run the dcn axis is the
  process boundary: process s holds ranks ``[s p_ici, (s + 1) p_ici)``.
- the four hierarchical collectives and :func:`hier_chunk_index`, each
  JAX's algorithm pairing. Each tier runs its family's registered
  schedule on a view of the operand where that tier's ranks are dim 0
  and the other tier's are a trailing batch dim, so every element is
  combined in the schedule's own order (bitwise JAX's). The ICI tier is
  always inside one process; the DCN tier runs under the dcn axis's
  ``transport.ProcessView`` across processes.

Chaos sites, JAX's: ``multihost.init`` (delay/die during bring-up) and
``multihost.hier.<op>`` at each hierarchical collective's dispatch.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from dataclasses import dataclass

import torch

from icikit_torch import chaos
from icikit_torch.parallel import transport
from icikit_torch.parallel.shmap import family_body
from icikit_torch.utils.mesh import (DEFAULT_AXIS, process_layout,
                                     split_ranks)

chaos.register_site("multihost.init",
                    *(f"multihost.hier.{c}" for c in
                      ("allreduce", "allgather", "reducescatter",
                       "alltoall")))

DCN_AXIS = "dcn"

# The ranks a hybrid mesh is carved from when the caller names none:
# JAX carves its mesh from the devices, 8 on the test suite's CPU mesh
# and in its two-process bring-up (4 a process); the port's ranks are
# rows, so it takes the same 8.
DEFAULT_RANKS = 8


def _cluster_detectable() -> bool:
    """True when the environment advertises a multi-process launch:
    ``torch.distributed``'s ``env://`` contract with more than one
    process (``MASTER_ADDR`` and ``WORLD_SIZE`` > 1, as ``torchrun``
    sets them). Env-only, as JAX's: it runs before any group exists."""
    if not os.environ.get("MASTER_ADDR"):
        return False
    try:
        return int(os.environ.get("WORLD_SIZE", "1")) > 1
    except ValueError:
        return False


def _distributed_live() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     **kw) -> bool:
    """Bring up the multi-process runtime (the ``MPI_Init`` analog).

    Explicit arguments mirror ``mpirun``'s contract (the coordinator,
    ``host:port`` or a ``torch.distributed`` init URL; how many of us;
    which one am I); with none, initializes only when the environment
    advertises a cluster, so a single process stays a no-op. ``kw`` goes
    to ``torch.distributed.init_process_group`` (``backend`` defaults to
    gloo, which runs here and, staged through host memory, beside one
    card; ``timeout``).

    Returns True iff the process group was (or already is) live.
    Idempotent: a second call is a no-op, the reference's
    one-``MPI_Init``-per-process discipline (``main.cc:396``).
    """
    chaos.maybe_delay("multihost.init")
    chaos.maybe_die("multihost.init")
    if _distributed_live():
        return True
    explicit = (coordinator_address is not None
                or num_processes is not None or process_id is not None)
    if not (explicit or _cluster_detectable()):
        return False
    import torch.distributed as dist
    if coordinator_address is not None and "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    kw.setdefault("backend", "gloo")
    try:
        dist.init_process_group(
            init_method=coordinator_address or "env://",
            world_size=-1 if num_processes is None else num_processes,
            rank=-1 if process_id is None else process_id, **kw)
    except (RuntimeError, ValueError):
        # raced double init (another caller won between the liveness
        # probe and here): live is live, the idempotent contract
        if _distributed_live():
            return True
        raise
    return True


def process_info() -> tuple[int, int, int]:
    """(process index, process count, local device count): the
    process-level ``MPI_Comm_rank``/``MPI_Comm_size``
    (``main.cc:398-400``); the devices are the CUDA cards this process
    sees, or the one CPU."""
    proc, procs = process_layout()
    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return proc, procs, local


LAUNCH_ATTEMPTS = 3


def launch_processes(module: str, argv: list, n: int, out: str,
                     timeout: float, env=None, cwd=None) -> list:
    """Start ``n`` workers, ``python -m module *argv --port P
    --process-id i``, on a fresh coordinator port P and wait for all of
    them, ``timeout`` seconds at most; once one fails, the others get
    five seconds before they are killed. Each worker's output goes to
    ``out/worker<i>.log``. A failure whose output shows a lost port
    race (``utils.net.PORT_RACE_SIGS``) retries on a fresh port,
    LAUNCH_ATTEMPTS times in all. Returns ``[(returncode, output)]`` (a
    negative code for a worker killed at the deadline); ``free_port``'s
    ``OSError`` (no local port can be bound) propagates."""
    from icikit_torch.utils.net import PORT_RACE_SIGS, free_port

    os.makedirs(out, exist_ok=True)
    results = []
    for _ in range(LAUNCH_ATTEMPTS):
        port = free_port()
        logs = [os.path.join(out, f"worker{i}.log") for i in range(n)]
        procs = []
        for i, log in enumerate(logs):
            with open(log, "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", module, *argv, "--port",
                     str(port), "--process-id", str(i)],
                    stdout=f, stderr=subprocess.STDOUT, env=env, cwd=cwd))
        deadline = time.monotonic() + timeout
        failed_at = None
        while any(p.poll() is None for p in procs):
            now = time.monotonic()
            if failed_at is None and any(p.poll() not in (None, 0)
                                         for p in procs):
                failed_at = now
            if now > deadline or (failed_at and now > failed_at + 5):
                break
            time.sleep(0.1)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        results = []
        for p, log in zip(procs, logs):
            with open(log) as f:
                results.append((p.returncode, f.read()))
        if all(c == 0 for c, _ in results):
            return results
        if not any(sig in o for _, o in results for sig in PORT_RACE_SIGS):
            return results
    return results


@dataclass(frozen=True)
class HybridMesh:
    """A (dcn, ici) rank mesh on ``device``: flat rank ``s * ici + j`` is
    chip j of slice s. Across ``procs`` processes (= dcn), process s
    holds slice s, ranks ``[s ici, (s + 1) ici)``, as its rows."""
    dcn: int
    ici: int
    device: str = "cuda"
    axis_names: tuple = (DCN_AXIS, DEFAULT_AXIS)
    procs: int = 1
    proc: int = 0

    def __post_init__(self):
        if self.procs not in (1, self.dcn):
            raise ValueError(f"a hybrid mesh of dcn={self.dcn} spans one "
                             f"process or {self.dcn}, not {self.procs}")
        split_ranks(self.p, self.procs, self.proc)

    @property
    def p(self) -> int:
        return self.dcn * self.ici

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: self.dcn, self.axis_names[1]: self.ici}

    @property
    def local(self) -> tuple[int, int]:
        """[lo, hi): the flat ranks this process holds, its rows."""
        return split_ranks(self.p, self.procs, self.proc)


def make_hybrid_mesh(dcn_size: int | None = None,
                     ici_size: int | None = None,
                     axis_names: tuple[str, str] = (DCN_AXIS, DEFAULT_AXIS),
                     device="cuda",
                     n_ranks: int = DEFAULT_RANKS) -> HybridMesh:
    """Build a 2-D (dcn, ici) mesh from ``n_ranks`` ranks (JAX's
    ``devices``).

    In a multi-process run the outer axis is the process boundary: dcn
    defaults to the process count and must equal it, each process
    holding ``ici_size`` ranks (at most ``n_ranks / processes``). In a
    single process the same logical shape is carved from the flat
    ranks, so every hierarchical schedule runs without a cluster:
    ``dcn_size`` plays the number of hosts (default 1).
    """
    proc, nproc = process_layout()
    n = n_ranks
    if dcn_size is None:
        dcn_size = nproc if nproc > 1 else 1
    if ici_size is None:
        if n % dcn_size:
            raise ValueError(
                f"{n} ranks do not divide into dcn_size={dcn_size}")
        ici_size = n // dcn_size
    if dcn_size * ici_size > n:
        raise ValueError(
            f"requested {dcn_size}x{ici_size} mesh but only {n} ranks")
    names = tuple(axis_names)
    if nproc == 1:
        return HybridMesh(dcn_size, ici_size, device, names)
    if dcn_size != nproc or ici_size > n // nproc:
        raise ValueError(
            f"cannot carve a ({dcn_size}, {ici_size}) hybrid mesh from "
            f"{nproc} processes with {n // nproc} ranks each")
    return HybridMesh(dcn_size, ici_size, device, names, nproc, proc)


def _tiers(mesh: HybridMesh, x: torch.Tensor, dcn_axis: str,
           ici_axis: str, what: str):
    """(p_dcn, p_ici, the dcn axis's process view or None, x on the
    mesh's device) after checking x holds this process's ranks."""
    p_dcn, p_ici = mesh.shape[dcn_axis], mesh.shape[ici_axis]
    lo, hi = mesh.local
    if x.shape[0] != hi - lo:
        raise ValueError(f"{what} needs one row a rank ({hi - lo} here); "
                         f"got {tuple(x.shape)}")
    view = (None if mesh.procs == 1
            else transport.ProcessView(p_dcn, mesh.procs, mesh.proc))
    return p_dcn, p_ici, view, x.to(mesh.device)


def hierarchical_all_reduce(x: torch.Tensor, mesh: HybridMesh,
                            dcn_axis: str = DCN_AXIS,
                            ici_axis: str = DEFAULT_AXIS,
                            op: str = "sum",
                            ici_algorithm: str = "ring",
                            dcn_algorithm: str = "ring") -> torch.Tensor:
    """Two-tier allreduce: reduce-scatter within each slice (ICI),
    allreduce of the scattered chunks across slices (DCN), allgather
    back within the slice. Per rank, DCN carries an m/p_ici chunk where
    a flat schedule would carry m.

    Args:
      x: ``(p_dcn * p_ici, m)``, rank ``s * p_ici + j``'s row (across
        processes, this process's slice); ``m`` divisible by p_ici.
      ici_algorithm: the reduce-scatter/allgather schedule within the
        slice; "recursive_doubling" or "recursive_halving" selects
        recursive_halving for the reduce-scatter and recursive_doubling
        for the allgather, as in JAX.
      dcn_algorithm: the allreduce schedule across slices.

    Returns:
      The same shape; every row the full elementwise reduction.
    """
    chaos.maybe_delay("multihost.hier.allreduce")
    chaos.maybe_die("multihost.hier.allreduce")
    p_ici = mesh.shape[ici_axis]
    if x.dim() != 2 or x.shape[1] % p_ici:
        raise ValueError(
            f"hierarchical_all_reduce needs (p, m) input with m divisible "
            f"by p_ici={p_ici}; got {tuple(x.shape)}")
    rs_name = {"recursive_doubling": "recursive_halving"}.get(
        ici_algorithm, ici_algorithm)
    ag_name = {"recursive_halving": "recursive_doubling"}.get(
        ici_algorithm, ici_algorithm)
    p_dcn, p_ici, view, x = _tiers(mesh, x, dcn_axis, ici_axis,
                                   "hierarchical_all_reduce")
    m = x.shape[1]
    xs = x.view(-1, p_ici, m)                                # [s, j, :]
    chunk = family_body("reducescatter", rs_name, p_ici, op)(
        xs.permute(1, 2, 0))                                 # [j, :, s]
    with transport.processes(view):
        red = family_body("allreduce", dcn_algorithm, p_dcn, op)(
            chunk.permute(2, 1, 0))                          # [s, :, j]
    full = family_body("allgather", ag_name, p_ici)(
        red.permute(2, 1, 0))                                # [j, j', :, s]
    return full.permute(3, 0, 1, 2).reshape(-1, m)


def hierarchical_all_gather(x: torch.Tensor, mesh: HybridMesh,
                            dcn_axis: str = DCN_AXIS,
                            ici_axis: str = DEFAULT_AXIS,
                            ici_algorithm: str = "ring",
                            dcn_algorithm: str = "ring") -> torch.Tensor:
    """Two-tier allgather: across slices first (the original blocks
    cross DCN), then the x p_ici expansion within the slice.

    Args:
      x: ``(p_dcn * p_ici, m)``, rank ``s * p_ici + j``'s block.

    Returns:
      ``(p, p, m)``: every rank's row holds all p blocks in global
      order, the flat ``all_gather_blocks`` contract.
    """
    chaos.maybe_delay("multihost.hier.allgather")
    chaos.maybe_die("multihost.hier.allgather")
    if x.dim() != 2:
        raise ValueError(
            f"hierarchical_all_gather needs (p, m) input; got "
            f"{tuple(x.shape)}")
    p_dcn, p_ici, view, x = _tiers(mesh, x, dcn_axis, ici_axis,
                                   "hierarchical_all_gather")
    m = x.shape[1]
    with transport.processes(view):
        g = family_body("allgather", dcn_algorithm, p_dcn)(
            x.view(-1, p_ici, m))                            # [s, s', j, :]
    g = family_body("allgather", ici_algorithm, p_ici)(
        g.permute(2, 0, 1, 3))                               # [j, j', s, s']
    return g.permute(2, 0, 3, 1, 4).reshape(-1, p_dcn * p_ici, m)


def hier_chunk_index(mesh: HybridMesh, dcn_axis: str = DCN_AXIS,
                     ici_axis: str = DEFAULT_AXIS) -> torch.Tensor:
    """Global chunk id each rank holds after
    :func:`hierarchical_reduce_scatter`: rank (s, j) = row s*p_ici + j
    ends with chunk j*p_dcn + s ((ici, dcn)-major). An int64 CPU
    tensor over the p ranks."""
    p_dcn, p_ici = mesh.shape[dcn_axis], mesh.shape[ici_axis]
    r = torch.arange(p_dcn * p_ici)
    return (r % p_ici) * p_dcn + r // p_ici


def hierarchical_reduce_scatter(x: torch.Tensor, mesh: HybridMesh,
                                dcn_axis: str = DCN_AXIS,
                                ici_axis: str = DEFAULT_AXIS,
                                op: str = "sum",
                                ici_algorithm: str = "ring",
                                dcn_algorithm: str = "ring"
                                ) -> torch.Tensor:
    """Two-tier reduce-scatter: ICI reduces m to m/p_ici, then only
    that chunk crosses DCN.

    Args:
      x: ``(p, m)``, rank r's row; ``m`` divisible by p.

    Returns:
      ``(p, m/p)``: each rank holds one fully reduced chunk, in (ici,
      dcn)-major order (:func:`hier_chunk_index`).
    """
    chaos.maybe_delay("multihost.hier.reducescatter")
    chaos.maybe_die("multihost.hier.reducescatter")
    p_ici = mesh.shape[ici_axis]
    p_dcn = mesh.shape[dcn_axis]
    if x.dim() != 2 or x.shape[1] % (p_ici * p_dcn):
        raise ValueError(
            f"hierarchical_reduce_scatter needs (p, m) with m divisible "
            f"by p={p_ici * p_dcn}; got {tuple(x.shape)}")
    p_dcn, p_ici, view, x = _tiers(mesh, x, dcn_axis, ici_axis,
                                   "hierarchical_reduce_scatter")
    m = x.shape[1]
    chunk = family_body("reducescatter", ici_algorithm, p_ici, op)(
        x.view(-1, p_ici, m).permute(1, 2, 0))               # [j, :, s]
    with transport.processes(view):
        piece = family_body("reducescatter", dcn_algorithm, p_dcn, op)(
            chunk.permute(2, 1, 0))                          # [s, :, j]
    return piece.permute(0, 2, 1).reshape(-1, m // (p_dcn * p_ici))


def hierarchical_all_to_all(x: torch.Tensor, mesh: HybridMesh,
                            dcn_axis: str = DCN_AXIS,
                            ici_axis: str = DEFAULT_AXIS,
                            ici_algorithm: str = "xla",
                            dcn_algorithm: str = "xla") -> torch.Tensor:
    """Two-tier distributed transpose (factorized all-to-all): an ICI
    exchange keyed by destination chip, then a DCN exchange keyed by
    destination slice, so cross-DCN messages aggregate x p_ici.

    Args:
      x: ``(p, p, m)``: rank d's row holds its p destination blocks in
        global (dcn, ici) row-major order.

    Returns:
      ``(p, p, m)`` equal to ``x.transpose(0, 1)``, the flat
      ``all_to_all_blocks`` contract.
    """
    chaos.maybe_delay("multihost.hier.alltoall")
    chaos.maybe_die("multihost.hier.alltoall")
    p = mesh.shape[dcn_axis] * mesh.shape[ici_axis]
    if x.dim() != 3 or x.shape[1] != p:
        raise ValueError(
            f"hierarchical_all_to_all needs (p, p, m) input with "
            f"p={p} destination blocks per device; got {tuple(x.shape)}")
    p_dcn, p_ici, view, x = _tiers(mesh, x, dcn_axis, ici_axis,
                                   "hierarchical_all_to_all")
    m = x.shape[2]
    xs = x.view(-1, p_ici, p_dcn, p_ici, m)       # [s, j, dest_s, dest_j]
    t = family_body("alltoall", ici_algorithm, p_ici)(
        xs.permute(1, 3, 0, 2, 4))                # [j, src_j, s, dest_s]
    with transport.processes(view):
        u = family_body("alltoall", dcn_algorithm, p_dcn)(
            t.permute(2, 3, 0, 1, 4))             # [s, src_s, j, src_j]
    return u.permute(0, 2, 1, 3, 4).reshape(-1, p, m)
