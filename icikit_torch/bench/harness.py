"""Collective benchmark harness: sweep, verify, time, report.

``icikit.bench.harness`` on the port's rank-vectorised collectives: the
reference's message-size sweeps (``Communication/src/main.cc:390-502``;
report.pdf Figs. 2-6), every variant of a family side by side against
the vendor baseline (the ``"xla"`` variant, PyTorch's own op over the
rank axis here). Payloads carry the reference's rank-derived pattern
and every rank's result is verified against the closed-form
expectation each run (``main.cc:431-441``), on the result's device.

``checked=True`` times the checksum-carrying schedules
(``parallel.integrity``) of the five checked families: the integrity
overhead's A/B rows. The ``xla`` variant is dropped from a checked
sweep and refused when named, as in JAX.

Across processes (a mesh split over ``torch.distributed`` processes,
``bench/procs.py``) every process makes the whole payload and runs its
ranks' rows, each timed window starts after a barrier, and the
verification gathers every process's rows before it compares.

Left out until ROADMAP A11 ports the host planes: JAX's chaos sites
(sweep-boundary delays and deaths, the verify-payload bit flip) and obs
spans and counters, so ``BenchRecord.trace_id`` stays empty.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Sequence

import torch

from icikit_torch.bench.procs import all_true, gather_rows, sync
from icikit_torch.parallel.allgather import all_gather_blocks
from icikit_torch.parallel.allreduce import all_reduce
from icikit_torch.parallel.alltoall import all_to_all_blocks
from icikit_torch.parallel.collops import (broadcast, gather_blocks,
                                           scatter_blocks)
from icikit_torch.parallel.integrity import CHECKED_FAMILIES
from icikit_torch.parallel.reduce import reduce_to_root
from icikit_torch.parallel.reducescatter import reduce_scatter
from icikit_torch.parallel.scan import scan_reduce
from icikit_torch.utils.mesh import (DEFAULT_AXIS, UnsupportedMeshError,
                                     mesh_axis_size, replicate)
from icikit_torch.utils.registry import list_algorithms
from icikit_torch.utils.timing import timeit

# Default sweep from the reference benchmark: msize = 2^l, l = 0,4,8,12,16
# for all-to-all (main.cc:422-423) and l <= 12 for personalized (:458).
REFERENCE_SWEEP = tuple(1 << l for l in range(0, 17, 4))
REFERENCE_SWEEP_PERSONALIZED = tuple(1 << l for l in range(0, 13, 4))

# each family's entry point, in the CLI's order
COLLECTIVES = {
    "allgather": all_gather_blocks,
    "alltoall": all_to_all_blocks,
    "allreduce": all_reduce,
    "reducescatter": reduce_scatter,
    "broadcast": broadcast,
    "scatter": scatter_blocks,
    "gather": gather_blocks,
    "scan": scan_reduce,
    "reduce": reduce_to_root,
}
FAMILIES = tuple(COLLECTIVES)


@dataclass
class BenchRecord:
    family: str
    algorithm: str
    p: int
    msize: int            # elements per block (the reference's "message size")
    dtype: str
    bytes_per_block: int
    runs: int
    mean_s: float
    best_s: float
    busbw_gbps: float     # effective per-rank bus bandwidth
    verified: bool
    # JAX's obs-trace id of the measurement; empty until the obs plane
    # is ported (ROADMAP A11)
    trace_id: str = ""
    # True when the row timed the checksum-carrying schedule
    checked: bool = False

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


def _bus_bytes(family: str, p: int, block_bytes: int) -> float:
    """Bytes each rank must move for one collective: the standard
    effective-bandwidth normalizations (so algorithms of one family are
    comparable, like the reference's time-vs-msize curves)."""
    if family in ("allgather", "alltoall"):
        return (p - 1) * block_bytes
    if family in ("scatter", "gather"):
        # the root link carries p-1 blocks either direction
        return (p - 1) * block_bytes
    if family == "allreduce":
        return 2 * block_bytes * (p - 1) / p
    if family == "reducescatter":
        # block_bytes records the output chunk; input is p chunks, of
        # which (p-1) chunk-sized partials cross the wire per rank.
        return (p - 1) * block_bytes
    if family == "broadcast":
        return block_bytes
    if family == "scan":
        # minimal per-rank movement: one running-prefix block in/out
        return block_bytes
    if family == "reduce":
        # each rank sends its partial up the tree once
        return block_bytes
    raise ValueError(family)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _pattern(p: int, msize: int, dtype: torch.dtype,
             device="cpu") -> torch.Tensor:
    """Rank-and-element-derived payload (main.cc:431-433), made on
    ``device``."""
    src = torch.arange(p, device=device)[:, None]
    k = torch.arange(msize, device=device)[None, :]
    return ((src * 7919 + k * 13) % 1000).to(dtype)


def _equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and bool((a == b).all())


def _setup(family: str, mesh, axis: str, msize: int, dtype: torch.dtype,
           checked: bool = False):
    """Build (run_fn, verify_fn) for one family; the payload is made on
    the mesh's device (across processes, each process's ranks' rows of
    it, and verify_fn gathers every process's rows)."""
    if checked and family not in CHECKED_FAMILIES:
        raise ValueError(
            f"checked mode covers {CHECKED_FAMILIES}, not {family}")
    p = mesh_axis_size(mesh, axis)
    dev = mesh.device
    lo, hi = getattr(mesh, "local", (0, p))
    if family in ("allgather", "broadcast", "gather", "allreduce", "scan",
                  "reduce"):
        data = _pattern(p, msize, dtype, dev)
    elif family == "alltoall":
        data = _pattern(p * p, msize, dtype, dev).reshape(p, p, msize)
    elif family == "scatter":
        data = _pattern(p, msize, dtype, dev)
    elif family == "reducescatter":
        # each rank contributes p chunks of msize; receives one chunk
        data = _pattern(p, p * msize, dtype, dev)
    else:
        raise ValueError(family)
    x = replicate(data, mesh) if family == "scatter" else data[lo:hi]

    mode = {"checked": True} if checked else {}

    def run(alg):
        return COLLECTIVES[family](x, mesh, axis, algorithm=alg, **mode)

    def verify(out) -> bool:
        return all_true(_verified(gather_rows(out, mesh)), mesh)

    def _verified(o) -> bool:
        if family == "allgather":
            return _equal(o, data.expand((p,) + data.shape))
        if family == "alltoall":
            return _equal(o, data.transpose(0, 1))
        if family == "allreduce":
            exp = data.sum(0, dtype=data.dtype)
            return _equal(o, exp.expand((p,) + exp.shape))
        if family == "broadcast":
            return _equal(o, data[:1].expand(data.shape))
        if family == "scatter":
            return _equal(o, data)
        if family == "gather":
            return _equal(o[0], data)
        if family == "reducescatter":
            return _equal(o, data.sum(0, dtype=data.dtype).reshape(p, msize))
        if family == "scan":
            return _equal(o, torch.cumsum(data, 0, dtype=data.dtype))
        if family == "reduce":
            # root holds the reduction (main.cc:445's MPI_Reduce), the
            # rest are zeroed by contract
            return (_equal(o[0], data.sum(0, dtype=data.dtype))
                    and not bool(o[1:].any()))
        return False

    return run, verify


def sweep_collective(mesh, family: str, algorithm: str,
                     sizes: Sequence[int] = REFERENCE_SWEEP,
                     dtype: torch.dtype = torch.int32, runs: int = 10,
                     warmup: int = 2, axis: str = DEFAULT_AXIS,
                     checked: bool = False) -> list[BenchRecord]:
    """Benchmark one algorithm across a message-size sweep: one verified
    run, then ``runs`` timed runs after ``warmup``, each fenced by a
    device synchronise."""
    p = mesh_axis_size(mesh, axis)
    records = []
    for msize in sizes:
        run, verify = _setup(family, mesh, axis, msize, dtype,
                             checked=checked)
        verified = verify(run(algorithm))
        block_bytes = msize * dtype.itemsize
        bus_bytes = _bus_bytes(family, p, block_bytes)
        sync(mesh.device)
        # a named range around the timing loop, so a profiler trace
        # attributes device work per collective and size
        with torch.profiler.record_function(
                f"{family}/{algorithm}/p{p}/m{msize}"):
            res = timeit(run, algorithm, runs=runs, warmup=warmup)
        records.append(BenchRecord(
            family=family, algorithm=algorithm, p=p, msize=msize,
            dtype=_dtype_name(dtype), bytes_per_block=block_bytes,
            runs=runs, mean_s=res.mean_s, best_s=res.best_s,
            busbw_gbps=bus_bytes / res.best_s / 1e9, verified=verified,
            checked=checked))
    return records


def sweep_family(mesh, family: str, algorithms: Sequence[str] | None = None,
                 **kw) -> list[BenchRecord]:
    """The reference's comparison study: every variant of a family side
    by side (report.pdf Figs. 2-6), skipping variants whose constraints
    (e.g. power-of-2) the mesh does not meet."""
    records = []
    algs = list(algorithms or list_algorithms(family))
    if kw.get("checked"):
        # the vendor variant is one opaque op, with no receive step to
        # fold checksums into: dropped from the default sweep, refused
        # when asked for by name
        if algorithms and "xla" in algs:
            raise ValueError(
                "checked mode cannot time the 'xla' vendor variant "
                "(no receive step to verify inside) — drop it from "
                "--algorithms")
        algs = [a for a in algs if a != "xla"]
    for alg in algs:
        try:
            records.extend(sweep_collective(mesh, family, alg, **kw))
        except UnsupportedMeshError:
            continue  # constraint not met on this mesh (e.g. non-pow2)
    return records


def format_table(records: list[BenchRecord]) -> str:
    """Human-readable comparison table (the reference printed per-run
    means to stdout; main.cc:447-449)."""
    if not records:
        return "(no records)"
    hdr = (f"{'family':<10} {'algorithm':<20} {'p':>3} {'msize':>8} "
           f"{'mean_us':>10} {'best_us':>10} {'busbw GB/s':>11} {'ok':>3}")
    lines = [hdr, "-" * len(hdr)]
    for r in records:
        lines.append(
            f"{r.family:<10} {r.algorithm:<20} {r.p:>3} {r.msize:>8} "
            f"{r.mean_s * 1e6:>10.1f} {r.best_s * 1e6:>10.1f} "
            f"{r.busbw_gbps:>11.3f} {'✓' if r.verified else '✗':>3}")
    return "\n".join(lines)
