"""Strong-scaling launcher: the reference's PBS batch script as code.

The port of ``icikit/bench/scaling.py``. The reference strong-scaled
one binary over np ∈ {2, ..., 128} by submitting ``mpirun -np $p`` once
per process count and redirecting stdout to a per-np file
(``Communication/Data/sub.sh:9-15``). Here every scale point is a
subprocess running the bench CLI (``icikit_torch.bench.run``, or
``bench.sort`` with ``bench="sort"``) with p ranks as rows of one
device (``device="cuda"``, the default, or ``"cpu"``), in one process;
with ``processes=k`` the point's p ranks split across k worker
processes of one gloo group (``--processes k``, ``bench/procs.py``),
each holding p/k of them, process 0 writing the records. Each point is
its own process, as in JAX, so one point's state never leaks into the
next.

Records come back as JSON dicts (the reference's per-np stdout files,
made machine-readable), each carrying ``processes``;
``bench.report`` renders them. The CLI's records go to the port's own
files (``scaling_torch.jsonl``, ``sort_scaling_torch.jsonl``,
``SORTSCALING_TORCH.md``), never the JAX package's.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

# One card holds the rank rows; 8 is the JAX package's simulated mesh.
DEFAULT_PS = (2, 4, 8)
DEFAULT_JSON = "scaling_torch.jsonl"
SORT_JSON = "sort_scaling_torch.jsonl"
SORT_MD = "SORTSCALING_TORCH.md"

_REPO_ROOT = str(Path(__file__).resolve().parents[2])


def _point_env() -> dict:
    env = dict(os.environ)
    keep = [x for x in env.get("PYTHONPATH", "").split(os.pathsep) if x]
    env["PYTHONPATH"] = os.pathsep.join([_REPO_ROOT] + keep)
    return env


def run_scale_point(family: str, p: int, *, algorithms=None, sizes=None,
                    runs: int = 5, dtype: str = "int32",
                    device: str = "cuda", processes: int = 1,
                    timeout_s: float = 600.0,
                    bench: str = "collectives",
                    checked: bool = False) -> list[dict]:
    """Run one scale point (one subprocess, or ``processes`` of them)
    and return its records.

    ``bench``: "collectives" sweeps a collective ``family`` through
    ``bench.run``; "sort" strong-scales the four sorts through
    ``bench.sort`` (``family`` is ignored).
    """
    if processes < 1 or p % processes:
        raise ValueError(f"{processes} processes cannot split {p} ranks")
    if checked and bench == "sort":
        raise ValueError(
            "checked scaling covers the collective sweeps only "
            "(--bench collectives): the sort bench has no --checked path")
    fd, json_path = tempfile.mkstemp(suffix=".jsonl")
    os.close(fd)
    try:
        if bench == "sort":
            # --windows 1: a relative-trend study; the median-of-windows
            # protocol of the headline buys nothing here
            cmd = [sys.executable, "-m", "icikit_torch.bench.sort",
                   "--devices", str(p), "--runs", str(runs),
                   "--dtype", dtype, "--windows", "1",
                   "--device", device, "--json", json_path]
        else:
            cmd = [sys.executable, "-m", "icikit_torch.bench.run",
                   "--family", family, "--devices", str(p),
                   "--runs", str(runs), "--dtype", dtype,
                   "--json", json_path]
            if device == "cpu":
                cmd.append("--simulate")
        if algorithms:
            cmd += ["--algorithms", ",".join(algorithms)]
        if sizes:
            cmd += ["--sizes", ",".join(str(s) for s in sizes)]
        if checked:
            cmd.append("--checked")
        if processes > 1:
            cmd += ["--processes", str(processes),
                    "--process-timeout", str(timeout_s)]
        proc = subprocess.run(cmd, env=_point_env(), capture_output=True,
                              text=True, timeout=timeout_s + 90,
                              cwd=_REPO_ROOT)
        with open(json_path) as f:
            records = [json.loads(line) for line in f if line.strip()]
        if proc.returncode != 0:
            # rc 1 with complete records: verification failures the
            # bench folded into them (errors > 0 / verified False),
            # surfaced as flagged rows. Any other failure aborts.
            if not (proc.returncode == 1 and records):
                raise RuntimeError(
                    f"scale point p={p} processes={processes} failed "
                    f"(rc={proc.returncode}):\n{proc.stdout[-2000:]}\n"
                    f"{proc.stderr[-2000:]}")
        return records
    finally:
        os.unlink(json_path)


def run_scaling_sweep(family: str, ps=DEFAULT_PS, **kw) -> list[dict]:
    """Strong-scaling study: the same workload at every rank count,
    concatenated into one record list (each record carries its p)."""
    records = []
    for p in ps:
        records.extend(run_scale_point(family, p, **kw))
    return records


def _render_sort_scaling(records: list[dict]) -> str:
    """keys/s vs p, algorithms as columns (project3.pdf's figure).
    Several records per (algorithm, p, processes, n) collapse to the
    best verified reading."""
    algs = sorted({r["algorithm"] for r in records})
    out = ["## Measured: Mkeys/s vs p\n",
           "> Cells collapse appended records to the best verified\n"
           "> reading (chained-best, `--windows 1`); a p of k processes\n"
           "> is written p/k. The ranks are rows of one device, so the\n"
           "> comparison is algorithm against algorithm; the headline\n"
           "> sort numbers are chip_smoke.py's median-of-windows.\n"]
    for n in sorted({r["n"] for r in records}):
        rows = []
        points = sorted({(r["p"], r.get("processes", 1)) for r in records
                         if r["n"] == n})
        for p, k in points:
            cell = {}
            for r in records:
                if (r["n"], r["p"], r.get("processes", 1)) != (n, p, k):
                    continue
                best = cell.get(r["algorithm"])
                # verified records displace errored ones; among equals
                # the best wins
                if (best is None
                        or (r["errors"] == 0 and best["errors"] > 0)
                        or (min(r["errors"], 1) == min(best["errors"], 1)
                            and r["keys_per_s"] > best["keys_per_s"])):
                    cell[r["algorithm"]] = r
            row = [str(p) if k == 1 else f"{p}/{k}"]
            for a in algs:
                r = cell.get(a)
                row.append(f"{r['keys_per_s'] / 1e6:.1f}"
                           + ("" if r["errors"] == 0 else " ✗")
                           if r else "—")
            rows.append(row)
        out.append(f"### n = 2^{n.bit_length() - 1} (Mkeys/s vs p)\n")
        out.append("| p | " + " | ".join(algs) + " |")
        out.append("|" + "|".join("---" for _ in range(len(algs) + 1)) + "|")
        out += ["| " + " | ".join(r) + " |" for r in rows]
        out.append("")
    return "\n".join(out)


_GEN_BEGIN = "<!-- generated: sort-scaling data (do not edit) -->"
_GEN_END = "<!-- /generated -->"


def write_sort_scaling_md(jsonl_path: str = SORT_JSON,
                          out_path: str = SORT_MD) -> None:
    """Refresh the port's sort-scaling document's generated block (the
    measured tables, the figure, the analytic counts and the
    crossovers) from its records, keeping the text around it."""
    from icikit_torch.bench.crossover import crossover_table
    from icikit_torch.bench.crossover import render_markdown as render_cross
    from icikit_torch.bench.outputs import check_output
    from icikit_torch.bench.schedule_stats import render_sort_markdown

    check_output(out_path)
    with open(jsonl_path) as f:
        records = [json.loads(ln) for ln in f if ln.strip()]
    ps = tuple(sorted({r["p"] for r in records})) or DEFAULT_PS
    gen = "\n".join([
        _GEN_BEGIN,
        "",
        _render_sort_scaling(records),
        "![sort scaling](docs/figs_torch/sort_scaling_p.png)",
        "",
        render_sort_markdown(ps=ps, n=1 << 20),
        render_cross(crossover_table(1 << 20)),
        # the reference's own headline pair (project3.pdf §4)
        render_cross(crossover_table(
            1 << 20, incumbent="sample", challenger="sample_bitonic")),
        _GEN_END,
    ])
    try:
        with open(out_path) as f:
            text = f.read()
    except FileNotFoundError:
        text = "# Strong scaling of the port: the four distributed sorts\n\n"
    if _GEN_BEGIN in text and _GEN_END in text:
        head = text[:text.index(_GEN_BEGIN)]
        tail = text[text.index(_GEN_END) + len(_GEN_END):]
        text = head + gen + tail
    else:
        text = text.rstrip() + "\n\n" + gen + "\n"
    with open(out_path, "w") as f:
        f.write(text)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bench", default="collectives",
                    choices=["collectives", "sort"],
                    help="'sort' strong-scales the four sorts "
                         "(project3.pdf's figure); 'collectives' sweeps "
                         "--family")
    ap.add_argument("--family", default="allgather")
    ap.add_argument("--ps", default=None,
                    help="comma-separated rank counts (default: 2,4,8)")
    ap.add_argument("--algorithms", default=None)
    ap.add_argument("--sizes", default=None)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--dtype", default="int32")
    ap.add_argument("--checked", action="store_true",
                    help="sweep the checksum-carrying schedules "
                         "(collectives only)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--processes", type=int, default=1,
                    help="split each point's ranks across this many OS "
                         "processes (the mpirun -np analog)")
    ap.add_argument("--json", dest="json_path", default=None,
                    help=f"append the records here (default: "
                         f"{DEFAULT_JSON}, or {SORT_JSON} with --bench "
                         f"sort)")
    ap.add_argument("--report", dest="report_path", default=None,
                    help="also render a markdown report to this path")
    ap.add_argument("--sort-report", dest="sort_report",
                    action="store_true",
                    help=f"refresh {SORT_MD}'s generated tables from the "
                         "sort records and exit (no new measurements)")
    args = ap.parse_args(argv)
    if args.checked and args.bench != "collectives":
        ap.error("--checked covers --bench collectives only "
                 "(the sort bench has no --checked path)")
    from icikit_torch.bench.outputs import check_output
    json_path = args.json_path or (SORT_JSON if args.bench == "sort"
                                   or args.sort_report else DEFAULT_JSON)
    check_output(json_path)
    if args.report_path:
        check_output(args.report_path)

    if args.sort_report:
        write_sort_scaling_md(json_path)
        print(f"updated {SORT_MD}")
        return 0

    ps = (tuple(int(x) for x in args.ps.split(","))
          if args.ps else DEFAULT_PS)
    records = run_scaling_sweep(
        args.family, ps,
        algorithms=args.algorithms.split(",") if args.algorithms else None,
        sizes=(tuple(int(s) for s in args.sizes.split(","))
               if args.sizes else None),
        runs=args.runs, dtype=args.dtype, device=args.device,
        processes=args.processes, bench=args.bench, checked=args.checked)

    if args.bench == "sort":
        text = _render_sort_scaling(records)
    else:
        from icikit_torch.bench.report import render_report
        text = render_report(records,
                             title=f"Strong scaling: {args.family}")
    print(text)
    # append: record files accumulate across invocations
    with open(json_path, "a") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    if args.report_path:
        with open(args.report_path, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
