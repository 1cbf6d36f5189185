"""Distributed-sorting benchmark: the reference's four-sort study as a
CLI, with the card's memory nameplate and the physical floor of a sort.

The port of ``icikit/bench/sort.py``. It reproduces ``Parallel-Sorting``'s
driver science (``psort.cc:525-663``; ``project3.pdf`` §4: four
algorithms side by side over problem sizes) on the p ranks of one card:
p-invariant input generation (uniform or the skewed ``ODD_DIST``,
``utils.prandom``), every registered sort, the inversion-count verifier
and a comparison with ``torch.sort`` (an oracle only) after each, and
chained timing: each timed run sorts the previous output scrambled, so
every run sorts new keys of the recorded distribution. Each record adds
the ``net``/``cross`` kernel launches and capacity retries of one sort,
``torch.sort``'s time for the same keys, the sort's floor, and the
card's name and power limit.

CLI::

    python -m icikit_torch.bench.sort --sizes 16777216 --device cuda
    python -m icikit_torch.bench.sort --reference-float
    python -m icikit_torch.bench.sort --device cpu --sizes 65536 --windows 1
    python -m icikit_torch.bench.sort --device cpu --sizes 65536 \
        --windows 1 --processes 2

``--processes k`` splits the ranks across k OS processes
(``bench/procs.py``): every process makes the whole key set and sorts
its ranks' part, the verification runs across the processes
(``check_sort``, and the output against its part of ``torch.sort``'s on
every process), the timing is a fixed count of fenced sorts (protocol
"fixed-runs": an adaptive window would size itself on each process's
own clock), and process 0 prints and writes the records.

Exit code 1 when a sort fails its verification, 2 without a card (unless
``--device cpu``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from dataclasses import dataclass

import torch

from icikit_torch.ops.cuda_sort import sort_passes

# Published device-memory rates (NVIDIA data sheets). The SXM part
# reports itself to CUDA as "NVIDIA H100 80GB HBM3", the PCIe part as
# "NVIDIA H100 PCIe". Other names get no nameplate.
_H100_SXM_BPS = 3.35e12
_H100_PCIE_BPS = 2.0e12


def hbm_nameplate_bytes(device_name: str | None = None) -> float | None:
    """Nameplate memory bandwidth (bytes/s) of the card, keyed on its
    CUDA name (default: device 0's); None for a name not known here or
    without a card."""
    if device_name is None:
        if not torch.cuda.is_available():
            return None
        device_name = torch.cuda.get_device_name(0)
    if "H100" not in device_name:
        return None
    if "PCIe" in device_name:
        return _H100_PCIE_BPS
    if "HBM3" in device_name or "SXM" in device_name:
        return _H100_SXM_BPS
    return None


def sort_floor_s(n: int, p: int, itemsize: int,
                 device_name: str | None = None) -> float | None:
    """Physical lower bound on one sort's seconds: each kernel launch of
    the local sort of a rank's share n/p reads and writes it once, at
    the nameplate rate, and all p ranks share the one card. Windows
    faster than this are impossible and are discarded by
    ``timeit_windows``. None without a nameplate."""
    bw = hbm_nameplate_bytes(device_name)
    if bw is None:
        return None
    n_loc = max(1, n // p)
    return 2.0 * p * n_loc * itemsize * sort_passes(n_loc) / bw


MULT = -1640531527       # the odd multiplier of the integer chain


@dataclass
class SortRecord:
    algorithm: str
    p: int
    n: int
    dtype: str
    distribution: str     # "uniform" | "odd_dist"
    runs: int
    mean_s: float         # the headline per-sort seconds (median under
    best_s: float         # the windows protocol)
    keys_per_s: float     # n / mean_s
    errors: int           # inversion count (0 = sorted)
    protocol: str = "chained-best"
    min_s: float = 0.0
    max_s: float = 0.0
    windows: int = 1
    discarded: int = 0    # implausibly-fast windows dropped
    suspect: bool = False  # every window fell below the physical floor
    session_quality: dict | None = None
    matches_torch_sort: bool = False  # output equal to torch.sort's
    launches: dict | None = None      # net/cross launches of one sort
    retries: dict | None = None       # capacity retries of one sort
    timed_runs: int = 0               # sorts run by the timing
    timed_retries: dict | None = None  # capacity retries in those runs
    torch_sort_s: float | None = None  # torch.sort of the same keys
    floor_s: float | None = None       # sort_floor_s
    device: str = "cpu"
    power_limit: str | None = None
    processes: int = 1                 # OS processes the ranks split over

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


def study_keys(n: int, dtype: torch.dtype, odd_dist: bool, seed: int = 0,
               device: str = "cuda") -> torch.Tensor:
    """The study's keys: ``uniform_global`` draws, integers spread over
    the dtype's whole range (``icikit/bench/sort.py:100-107``)."""
    from icikit_torch.utils.prandom import uniform_global
    u = uniform_global(seed, n, odd_dist=odd_dist, device=device)
    if dtype.is_floating_point:
        return u.to(dtype)
    info = torch.iinfo(dtype)
    return (u * (float(info.max) - float(info.min))
            + float(info.min)).to(dtype)


def study_chain(dtype: torch.dtype, odd_dist: bool):
    """The timed runs' chain (``icikit/bench/sort.py:121-150``): a
    bijective odd-multiplier scramble of the last output for integers,
    an affine map mod 1 in float32 for floats (bf16's 8-bit mantissa
    would collapse the orbit to a handful of values), and, under
    odd_dist, the skew re-applied. The skew maps its smallest draws to
    the integer minimum, which the scramble keeps, so under odd_dist
    integer keys gather there run by run (about 3.6% of the keys more a
    run): the timed runs sort a more skewed distribution than the
    recorded one, and records count the retries they take
    (``timed_retries``)."""
    from icikit_torch.utils.prandom import odd_dist_warp

    def chain(args, out):
        if not dtype.is_floating_point:
            mixed = out * MULT
            if not odd_dist:
                return (mixed,)
            info = torch.iinfo(dtype)
            span = float(info.max) - float(info.min)
            u01 = (mixed.to(torch.float32) - float(info.min)) / span
            return ((odd_dist_warp(u01) * span + float(info.min)
                     ).to(dtype),)
        mixed = (out.to(torch.float32) * 25.173 + 0.217) % 1.0
        return ((odd_dist_warp(mixed) if odd_dist else mixed).to(dtype),)

    return chain


def _errors(out: torch.Tensor, p: int, mesh) -> int:
    """Inversions of a flat sorted output, by ``check_sort`` over p
    blocks (padded with its last key); across processes ``out`` is this
    process's part, whole blocks of its ranks."""
    from icikit_torch.models.sort import check_sort
    n = out.shape[0]
    if n < 2:
        return 0
    rows = p // mesh.procs
    pad = (-n) % rows
    full = torch.cat([out, out[-1:].expand(pad)])
    return check_sort(full.reshape(rows, -1), mesh)


def sweep_sorts(mesh, sizes, algorithms=None, dtype="int32",
                odd_dist=False, runs=4, warmup=1, seed=0, windows=3):
    """Benchmark and verify each sort over a size sweep on ``mesh``'s
    device (across processes, each process sorting its ranks' part).

    ``windows >= 2`` uses the median-of-windows protocol
    (``timeit_windows``: median and [min, max], windows below
    ``sort_floor_s`` discarded); ``windows=1`` one chained two-point
    measurement (``timeit_chained``); ``windows=0`` verifies without
    timing."""
    from icikit_torch.bench.headline import device_identity
    from icikit_torch.bench.procs import all_true, sync
    from icikit_torch.models.sort import SORT_ALGORITHMS, sort
    from icikit_torch.models.sort.common import RETRIES, reset_retries
    from icikit_torch.ops import cuda_sort as cs
    from icikit_torch.utils.mesh import UnsupportedMeshError, mesh_axis_size
    from icikit_torch.utils.timing import (timeit, timeit_chained,
                                           timeit_windows)

    p = mesh_axis_size(mesh)
    lo, hi = mesh.local
    device = mesh.device
    on_card = torch.device(device).type == "cuda"
    name, power = device_identity(device)
    algorithms = list(algorithms or SORT_ALGORITHMS)
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    dist = "odd_dist" if odd_dist else "uniform"
    records = []
    for n in sizes:
        whole = study_keys(n, dt, odd_dist, seed, device)
        lib = (timeit(lambda: torch.sort(whole), runs=max(runs, 1),
                      warmup=1).mean_s if windows else None)
        part = slice(lo * n // p, hi * n // p)  # this process's ranks'
        keys = whole[part]
        oracle = torch.sort(whole).values[part]
        del whole
        floor = sort_floor_s(n, p, keys.element_size(), name) \
            if on_card else None
        for alg in algorithms:
            calls = [0]

            def run(x, alg=alg, calls=calls):
                calls[0] += 1
                return sort(x, mesh, algorithm=alg)

            cs.reset_launches()
            reset_retries()
            try:
                out = run(keys)
            except UnsupportedMeshError:
                continue  # bitonic, quicksort, sample_bitonic at p = 6
            if on_card:
                torch.cuda.synchronize()
            launches, retries = dict(cs.LAUNCHES), dict(RETRIES)
            rec = dict(algorithm=alg, p=p, n=n, dtype=str(dt)[6:],
                       distribution=dist, errors=_errors(out, p, mesh),
                       matches_torch_sort=all_true(
                           bool(torch.equal(out, oracle)), mesh),
                       launches=launches, retries=retries,
                       torch_sort_s=lib, floor_s=floor, device=name,
                       power_limit=power, processes=mesh.procs)
            del out
            chain = study_chain(dt, odd_dist)
            calls[0] = 0
            reset_retries()
            sync(device)
            if windows and mesh.procs > 1:
                # a fixed count of sorts, each fenced: the adaptive
                # windows below size themselves on this process's
                # clock, and processes that ran different counts of a
                # collective sort would wait on each other forever
                r = timeit(run, keys, runs=runs, warmup=warmup)
                rec.update(runs=r.runs, mean_s=r.mean_s, best_s=r.best_s,
                           keys_per_s=n / r.best_s, protocol="fixed-runs")
            elif windows >= 2:
                w = timeit_windows(run, (keys,), chain, windows=windows,
                                   runs=runs, warmup=warmup, floor_s=floor)
                rec.update(runs=runs, mean_s=w.median_s, best_s=w.min_s,
                           keys_per_s=n / w.median_s,
                           protocol="median-of-windows", min_s=w.min_s,
                           max_s=w.max_s, windows=w.windows,
                           discarded=w.discarded, suspect=w.suspect,
                           session_quality=w.session_quality())
            elif windows == 1:
                r = timeit_chained(run, (keys,), chain, runs=runs,
                                   warmup=warmup)
                rec.update(runs=r.runs, mean_s=r.mean_s, best_s=r.best_s,
                           keys_per_s=n / r.best_s)
            else:
                rec.update(runs=0, mean_s=0.0, best_s=0.0, keys_per_s=0.0,
                           protocol="verified, not timed", windows=0)
            rec.update(timed_runs=calls[0], timed_retries=dict(RETRIES))
            records.append(SortRecord(**rec))
        del keys, oracle
    return records


def failed(r: SortRecord) -> bool:
    """A record whose sort did not verify: inversions, or an output
    that differs from ``torch.sort``'s."""
    return bool(r.errors) or not r.matches_torch_sort


def format_table(records) -> str:
    if not records:
        return "(no records)"
    hdr = (f"{'algorithm':<15} {'p':>3} {'n':>12} {'dtype':>9} "
           f"{'dist':>9} {'median_ms':>10} {'spread_ms':>17} "
           f"{'Mkeys/s':>9} {'sort_ms':>8} {'net':>5} {'cross':>5} "
           f"{'errs':>5}")
    lines = [hdr, "-" * len(hdr)]
    for r in records:
        spread = (f"[{r.min_s * 1e3:.1f},{r.max_s * 1e3:.1f}]"
                  if r.protocol == "median-of-windows"
                  else f"best={r.best_s * 1e3:.1f}")
        lib = ("-" if r.torch_sort_s is None
               else f"{r.torch_sort_s * 1e3:.2f}")
        launches = r.launches or {}
        lines.append(
            f"{r.algorithm:<15} {r.p:>3} {r.n:>12} {r.dtype:>9} "
            f"{r.distribution:>9} {r.mean_s * 1e3:>10.2f} {spread:>17} "
            f"{r.keys_per_s / 1e6:>9.1f} {lib:>8} "
            f"{launches.get('net', 0):>5} {launches.get('cross', 0):>5} "
            f"{r.errors:>5}"
            + ("" if r.matches_torch_sort else "  DIFFERS from torch.sort")
            + (f"  ({r.discarded} discarded)" if r.discarded else "")
            + ("  SUSPECT (all windows below floor)" if r.suspect else "")
            + ("  DEGRADED (spread never converged)"
               if (r.session_quality or {}).get("degraded") else ""))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sizes", default="1048576,16777216",
                    help="comma-separated key counts (BASELINE: 2^24 "
                         "int32 at p = 8)")
    ap.add_argument("--algorithms", default=None,
                    help="comma-separated (default: all four)")
    ap.add_argument("--dtype", default="int32")
    ap.add_argument("--odd-dist", action="store_true",
                    help="the reference's skewed ODD_DIST input "
                         "(psort.cc:598-609)")
    ap.add_argument("--reference-float", action="store_true",
                    help="the reference's float study at its scale "
                         "(project3.pdf p.5 §4: 50,000,000 doubles): "
                         "float32 and bfloat16, uniform and odd_dist; "
                         "overrides --sizes/--dtype/--odd-dist")
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--windows", type=int, default=3,
                    help="median-of-windows (median + [min, max]); 1 = "
                         "one chained two-point measurement; 0 = verify "
                         "only")
    ap.add_argument("--devices", type=int, default=8,
                    help="ranks of the mesh (default 8)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", dest="json_path", default=None,
                    help="append the records as JSON lines")
    from icikit_torch.bench import procs
    procs.add_process_args(ap)
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        print("no CUDA device: pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 2
    if args.json_path:
        from icikit_torch.bench.outputs import check_output
        check_output(args.json_path)
    rc = procs.relaunch(args, "icikit_torch.bench.sort",
                        procs.argv_of(argv))
    if rc is not None:
        return rc

    from icikit_torch.bench.headline import device_identity
    from icikit_torch.utils.mesh import make_mesh

    proc, _ = procs.join(args)

    mesh = make_mesh(args.devices, device=args.device)
    if args.reference_float:
        configs = [((50_000_000,), dtype, odd)
                   for dtype in ("float32", "bfloat16")
                   for odd in (False, True)]
    else:
        configs = [(tuple(int(s) for s in args.sizes.split(",")),
                    args.dtype, args.odd_dist)]
    name, power = device_identity(args.device)
    records = []
    for sizes, dtype, odd in configs:
        records += sweep_sorts(
            mesh, sizes,
            args.algorithms.split(",") if args.algorithms else None,
            dtype=dtype, odd_dist=odd, runs=args.runs,
            warmup=args.warmup, windows=args.windows)
    procs.leave()
    if proc == 0:
        print(f"device: {name}, power limit: {power}")
        print(format_table(records))
    if args.json_path and proc == 0:
        with open(args.json_path, "a") as f:
            for r in records:
                f.write(r.to_json() + "\n")
    if any(failed(r) for r in records):
        print("SORT VERIFICATION FAILURES present", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
