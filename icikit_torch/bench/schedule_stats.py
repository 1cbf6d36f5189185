"""Machine-independent schedule statistics: analytic round and byte counts.

The port of ``icikit/bench/schedule_stats.py``. The reference report
derives each algorithm's cost analytically (ts·rounds + tw·bytes forms,
``Communication/Data/report.pdf`` §§2.2-2.4) and checks measurements
against them; ``bench.scaling`` is the measured half, this module the
analytic half. JAX traces a schedule to a jaxpr and walks it. Here the
schedule runs once on ``meta`` tensors (shapes only: nothing computed,
no kernel, no card) and every communication call it makes is counted:

- each ``transport.ppermute`` (under a counting ``transport.Tracker``);
- each vendor collective, which the port computes on the rank axis and
  marks through ``transport.vendor`` with JAX's primitive: the ``xla``
  variants, and the all-gathers and psums inside the sorts and the
  ragged exchange. pmax and pmin are not communication in JAX's count,
  and are not here either.

Two machine-independent quantities per (family, algorithm, p, msize):

- ``rounds``, the critical communication depth: the longest chain of
  data-dependent communication calls. A ``TorchFunctionMode`` carries a
  depth on every tensor's storage (an op's output takes the largest
  depth among its tensor inputs, an in-place op raises its target's,
  a communication call adds one), so a schedule whose sends are
  independent (the naive allgather's p-1 rotations) has depth 1 though
  it issues p-1 calls.
- ``bytes_per_dev``: the bytes one rank sends, summed over calls (a
  ppermute sends a rank's row of its operand; the vendor collectives
  are credited with their bandwidth-optimal ring equivalents, as in
  JAX). Tree schedules count the busiest rank's sends.

The counts equal JAX's for every registered schedule and sort
(``tests/test_torch_schedule_stats.py``): the same code paths, counted
at the same sites.

CLI::

    python -m icikit_torch.bench.schedule_stats [--out SCALING_TORCH.md]

appends or refreshes the "Analytic round/byte counts" section of the
port's scaling study (pure analysis, no card, no timing).
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_flatten

from icikit_torch.parallel import transport
from icikit_torch.utils.mesh import DEFAULT_AXIS

# Communication primitives by JAX's name, with the bytes one rank sends
# as a function of (a rank's operand bytes, p): JAX's table.
_COMM_BYTES = {
    "ppermute": lambda nbytes, p: nbytes,
    "all_gather": lambda nbytes, p: nbytes * (p - 1),
    "all_to_all": lambda nbytes, p: nbytes * (p - 1) / p,
    "psum": lambda nbytes, p: 2 * nbytes * (p - 1) / p,
    "psum_invariant": lambda nbytes, p: 2 * nbytes * (p - 1) / p,
    "reduce_scatter": lambda nbytes, p: nbytes * (p - 1) / p,
}
_VENDOR = {"all_gather", "all_to_all", "psum", "psum_invariant",
           "reduce_scatter"}

DEFAULT_OUT = "SCALING_TORCH.md"


@dataclass
class ScheduleStats:
    family: str
    algorithm: str
    p: int
    msize: int
    rounds: int          # critical communication depth
    calls: int           # total communication calls
    bytes_per_dev: float  # per-rank bytes sent, summed over calls
    vendor_calls: int    # calls delegated to the vendor collectives


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class _Depth(TorchFunctionMode):
    """The communication depth of every tensor made or written while
    installed, by storage (a view shares its base's depth)."""

    def __init__(self):
        super().__init__()
        self.of: dict = {}
        self.max = 0

    def get(self, t: torch.Tensor) -> int:
        return self.of.get(_key(t), 0)

    def set(self, t: torch.Tensor, depth: int) -> None:
        self.of[_key(t)] = depth
        self.max = max(self.max, depth)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        leaves = tree_flatten((args, kwargs))[0]
        din = max((self.get(t) for t in leaves
                   if isinstance(t, torch.Tensor)), default=0)
        out = func(*args, **kwargs)
        if func is torch.Tensor.__setitem__:
            self.set(args[0], din)
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self.set(t, din)
        return out


class _Meter(transport.Tracker):
    """A tracker that counts each communication call of a run, its bytes
    and whether it is a vendor collective, and gives its result the
    depth of its operand plus one."""

    def __init__(self, p: int, depth: _Depth):
        super().__init__(DEFAULT_AXIS, None)
        self.p, self.depth = p, depth
        self.n_calls, self.bytes, self.vendor_calls = 0, 0.0, 0

    def _comm(self, prim: str, operand, out, din: int, per_rank_bytes):
        if per_rank_bytes is None:
            per_rank_bytes = (operand.numel() // max(operand.shape[0], 1)
                              * operand.element_size())
        self.n_calls += 1
        self.bytes += _COMM_BYTES[prim](per_rank_bytes, self.p)
        self.vendor_calls += prim in _VENDOR
        self.depth.set(out, din + 1)

    def checked_ppermute(self, x, perm):
        din = self.depth.get(x)
        y = transport.plain_ppermute(x, perm)
        self._comm("ppermute", x, y, din, None)
        return y

    def on_vendor(self, prim, operand, out, per_rank_bytes):
        if prim not in _COMM_BYTES:
            return out
        din = self.depth.get(operand)
        if _key(out) == _key(operand):  # the rank axis itself: a new value
            out = out.clone()
        self._comm(prim, operand, out, din, per_rank_bytes)
        return out


def _count(fn, x: torch.Tensor, p: int) -> tuple:
    """(rounds, calls, bytes a rank, vendor calls) of ``fn(x)``, run
    with every rank's rows and no process view."""
    depth = _Depth()
    meter = _Meter(p, depth)
    with transport.checked(meter), transport.no_view(), depth:
        fn(x)
    return depth.max, meter.n_calls, meter.bytes, meter.vendor_calls


def _global_shape(family: str, p: int, msize: int) -> tuple:
    if family == "alltoall":
        return (p, p, msize)
    if family == "reducescatter":
        return (p, p * msize)
    return (p, msize)


def analyze_collective(family: str, algorithm: str, p: int,
                       msize: int = 4096, dtype="float32",
                       axis: str = "p") -> ScheduleStats:
    """Run one registered schedule at (p, msize) on ``meta`` tensors
    and count its communication: no card, no data."""
    from icikit_torch.parallel.shmap import family_body

    del axis  # the port's ranks are one axis
    extra = {"allreduce": ("sum",), "reducescatter": ("sum",),
             "reduce": ("sum", 0), "scan": ("sum", True),
             "broadcast": (0,), "scatter": (0,), "gather": (0,)
             }.get(family, ())
    inner = family_body(family, algorithm, p, *extra)
    x = torch.empty(_global_shape(family, p, msize),
                    dtype=getattr(torch, dtype), device="meta")
    rounds, calls, nbytes, vendor = _count(inner, x, p)
    return ScheduleStats(family=family, algorithm=algorithm, p=p,
                         msize=msize, rounds=rounds, calls=calls,
                         bytes_per_dev=nbytes, vendor_calls=vendor)


def analyze_sort(algorithm: str, p: int, n: int,
                 dtype="int32") -> ScheduleStats:
    """Run one distributed sort's rank program at (p, n) on ``meta``
    tensors and count its communication: the analytic half of the
    four-sort scaling study (``project3.pdf`` §3's per-algorithm cost
    analysis, from the code itself).

    The counts are those of the default-capacity program, as JAX's:
    the capacity retries run it again and are not counted (they never
    fire at the measured defaults, ``sample.run_with_capacity_retry``).
    The round loops are Python loops, so the counts are exact.
    """
    from icikit_torch.models.sort.bitonic import bitonic_sort_shard
    from icikit_torch.models.sort.quicksort import hypercube_quicksort_shard
    from icikit_torch.models.sort import quicksort, sample

    n_loc = max(1, n // p)
    if algorithm == "bitonic":
        def fn(a):
            return bitonic_sort_shard(a, p)
    elif algorithm in ("sample", "sample_bitonic"):
        cap = max(1, min(n_loc,
                         int(sample.DEFAULT_CAP_FACTOR * n_loc / max(p, 1))))
        splitter = "allgather" if algorithm == "sample" else "bitonic"

        def fn(a):
            return sample.sample_sort_shard(a, p, cap, splitter)
    elif algorithm == "quicksort":
        cap = int(quicksort.DEFAULT_CAP_FACTOR * n_loc)

        def fn(a):
            return hypercube_quicksort_shard(a, p, cap)
    else:
        raise ValueError(f"unknown sort algorithm {algorithm!r}")
    x = torch.empty((p, n_loc), dtype=getattr(torch, dtype), device="meta")
    rounds, calls, nbytes, vendor = _count(fn, x, p)
    return ScheduleStats(family="sort", algorithm=algorithm, p=p,
                         msize=n, rounds=rounds, calls=calls,
                         bytes_per_dev=nbytes, vendor_calls=vendor)


def _cell(st: ScheduleStats) -> str:
    tag = "v" if st.vendor_calls else ""
    return f"{st.rounds}/{st.calls}{tag}/{st.bytes_per_dev / 1e6:.2f}"


def render_sort_markdown(ps=(2, 4, 8, 16, 32), n: int = 1 << 20,
                         dtype: str = "int32") -> str:
    """The four sorts' analytic table: rounds/calls/MB a rank."""
    from icikit_torch.models.sort import SORT_ALGORITHMS
    lines = [
        "## Analytic sort schedule counts (counted from the code)",
        "",
        "> Each sort's rank program run once on `meta` tensors at the",
        f"> shipped default capacities, n = 2^{n.bit_length() - 1} "
        f"{dtype}, counts exact",
        "> (the round loops are Python loops). `rounds` = critical",
        "> communication depth, `calls` = total communication calls",
        "> (what a serializing fabric pays), `MB/dev` = bytes a rank",
        "> sends. Analytic forms: bitonic moves the full block d(d+1)/2",
        "> times (d = log2 p); sample pays one splitter stage + one",
        "> capacity-padded exchange; the hybrid replaces the p(p-1)",
        "> serial sample sort with a d(d+1)/2 bitonic pass over p-sized",
        "> splitter blocks; quicksort pays d pivot-allgather + exchange",
        "> rounds on a shrinking cube: project3.pdf §3's cost analysis,",
        "> derived from the code.",
        "",
        "| algorithm | " + " | ".join(
            f"p={p} rounds/calls/MB-dev" for p in ps) + " |",
        "|---|" + "---|" * len(ps),
    ]
    for alg in SORT_ALGORITHMS:
        cells = []
        for p in ps:
            try:
                cells.append(_cell(analyze_sort(alg, p, n, dtype)))
            except Exception:
                cells.append("n/a")
        lines.append(f"| {alg} | " + " | ".join(cells) + " |")
    lines.append("")
    return "\n".join(lines)


# Families in the scaling study; the xla baselines included so the
# vendor-credit convention is visible in the table.
_STUDY = ("allgather", "alltoall", "allreduce", "reducescatter",
          "reduce", "scan")


def render_markdown(ps=(4, 8, 16, 32), msize: int = 4096,
                    families=_STUDY) -> str:
    from icikit_torch.utils.registry import list_algorithms
    lines = [
        "## Analytic round/byte counts (counted from the schedules)",
        "",
        "> Machine-independent validation of the cost models: each",
        "> algorithm's *own code* runs once on `meta` tensors and its",
        "> communication calls are counted. `rounds` = critical",
        "> communication depth (the ts latency term under unbounded",
        "> link parallelism: a schedule with independent sends, like",
        "> the naive allgather's rotations, has depth 1); `calls` = what",
        "> a serializing fabric pays instead. `MB/dev` = bytes a rank",
        f"> sends at msize={msize} f32 (vendor collectives credited with",
        "> their bandwidth-optimal ring equivalents; calls marked `v`",
        "> are the vendor's). Forms per report.pdf §§2.2-2.4.",
        "",
    ]
    for family in families:
        algs = list_algorithms(family)
        if not algs:
            continue
        lines.append(f"### {family}")
        lines.append("")
        lines.append("| algorithm | " + " | ".join(
            f"p={p} rounds/calls/MB-dev" for p in ps) + " |")
        lines.append("|---|" + "---|" * len(ps))
        for alg in algs:
            cells = []
            for p in ps:
                try:
                    cells.append(_cell(analyze_collective(family, alg, p,
                                                          msize)))
                except Exception as e:  # power-of-2-only schedules
                    cells.append("n/a" if "power-of-2" in str(e)
                                 or "Unsupported" in type(e).__name__
                                 else "err")
            lines.append(f"| {alg} | " + " | ".join(cells) + " |")
        lines.append("")
    return "\n".join(lines)


_MARKER = "## Analytic round/byte counts"


def update_scaling_md(path: str = DEFAULT_OUT) -> None:
    """Append or refresh the analytic section of the port's scaling
    study at ``path``."""
    from icikit_torch.bench.outputs import check_output
    check_output(path)
    section = render_markdown()
    try:
        with open(path) as f:
            text = f.read()
    except FileNotFoundError:
        text = ""
    if _MARKER in text:
        text = text[:text.index(_MARKER)].rstrip() + "\n\n" + section + "\n"
    else:
        text = text.rstrip() + "\n\n" + section + "\n"
    with open(path, "w") as f:
        f.write(text)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--print", dest="just_print", action="store_true",
                    help="print the section instead of updating --out")
    args = ap.parse_args(argv)
    if args.just_print:
        print(render_markdown())
    else:
        update_scaling_md(args.out)
        print(f"updated {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
