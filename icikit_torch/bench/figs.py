"""Figure artifacts: render the port's studies' curves from its records.

The port of ``icikit/bench/figs.py``, host-only: matplotlib is imported
inside the functions, so nothing that runs on the card imports it. The
reference communicates its science as curves
(``Communication/Data/report.pdf`` Figs. 2-6: time vs message size and
vs rank count; ``project3.pdf`` §4: sort throughput trends). This module
renders the port's records (``scaling_torch.jsonl`` from
``bench.scaling``, the sort rows of ``northstar_torch.jsonl``,
``longcontext_torch.jsonl``, ``sort_scaling_torch.jsonl``) into PNGs
under ``docs/figs_torch/``, never the JAX package's ``docs/figs/``; a
missing records file is skipped.

Design method: the dataviz procedure (form → color-by-job → validated
palette → mark specs). Colors are the validated reference categorical
palette assigned in *fixed per-entity order* (an algorithm keeps its
hue across every figure it appears in); marks are thin (2 px lines,
>= 8 px markers), the grid is recessive, one axis per chart, text in
neutral ink.

CLI::

    python -m icikit_torch.bench.figs [--outdir docs/figs_torch]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import defaultdict

# Validated reference categorical palette (light mode), fixed slots.
PALETTE = ("#2a78d6", "#eb6834", "#1baf7a", "#eda100", "#e87ba4",
           "#008300", "#4a3aa7")
SURFACE = "#fcfcfb"
INK = "#0b0b0b"
INK2 = "#52514e"
GRID = "#e4e3df"

# Fixed entity -> slot assignments (color follows the entity, never its
# rank or plotting order).
COLLECTIVE_SLOTS = {"xla": 0, "ring": 1, "recursive_doubling": 2,
                    "naive": 3, "recursive_doubling_twins": 4,
                    "hypercube": 5, "ecube": 2, "wraparound": 4,
                    "pairwise": 3, "recursive_halving": 2,
                    "binomial": 1, "hillis_steele": 2, "linear": 1}
SORT_SLOTS = {"bitonic": 0, "sample": 1, "sample_bitonic": 2,
              "quicksort": 3}


def _style(ax, title, xlabel, ylabel):
    ax.set_facecolor(SURFACE)
    ax.set_title(title, color=INK, fontsize=11, loc="left", pad=10)
    ax.set_xlabel(xlabel, color=INK2, fontsize=9)
    ax.set_ylabel(ylabel, color=INK2, fontsize=9)
    ax.grid(True, which="major", color=GRID, linewidth=0.8, zorder=0)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    for s in ("left", "bottom"):
        ax.spines[s].set_color(GRID)
    ax.tick_params(colors=INK2, labelsize=8)


def _legend(ax):
    leg = ax.legend(frameon=False, fontsize=8, labelcolor=INK2)
    return leg


def _load(path):
    try:
        with open(path) as f:
            return [json.loads(ln) for ln in f if ln.strip()]
    except FileNotFoundError:
        return []


def fig_scaling_msize(records, outdir, family="allgather", p=8):
    import matplotlib.pyplot as plt
    rows = [r for r in records if r.get("family") == family
            and r["p"] == p and not r.get("checked")]
    if not rows:
        return None
    by_alg = defaultdict(dict)
    for r in rows:
        cur = by_alg[r["algorithm"]].get(r["msize"])
        if cur is None or r["best_s"] < cur:
            by_alg[r["algorithm"]][r["msize"]] = r["best_s"]
    fig, ax = plt.subplots(figsize=(6.4, 4.0), facecolor=SURFACE)
    for alg in sorted(by_alg):
        pts = sorted(by_alg[alg].items())
        c = PALETTE[COLLECTIVE_SLOTS.get(alg, 6)]
        ax.plot([m for m, _ in pts], [t * 1e6 for _, t in pts],
                color=c, linewidth=2, marker="o", markersize=5,
                label=alg, zorder=3)
    ax.set_xscale("log", base=2)
    ax.set_yscale("log")
    _style(ax, f"{family}: best time vs message size, p={p} "
               "(ranks as rows of one device)",
           "message size (elements/block)", "best time (µs)")
    _legend(ax)
    path = os.path.join(outdir, f"scaling_{family}_msize_p{p}.png")
    fig.savefig(path, dpi=160, bbox_inches="tight", facecolor=SURFACE)
    plt.close(fig)
    return path


def fig_scaling_p(records, outdir, family="allgather", msize=65536):
    import matplotlib.pyplot as plt
    rows = [r for r in records if r.get("family") == family
            and r["msize"] == msize and not r.get("checked")]
    if not rows:
        return None
    by_alg = defaultdict(dict)
    for r in rows:
        cur = by_alg[r["algorithm"]].get(r["p"])
        if cur is None or r["best_s"] < cur:
            by_alg[r["algorithm"]][r["p"]] = r["best_s"]
    fig, ax = plt.subplots(figsize=(6.4, 4.0), facecolor=SURFACE)
    for alg in sorted(by_alg):
        pts = sorted(by_alg[alg].items())
        c = PALETTE[COLLECTIVE_SLOTS.get(alg, 6)]
        ax.plot([p for p, _ in pts], [t * 1e3 for _, t in pts],
                color=c, linewidth=2, marker="o", markersize=5,
                label=alg, zorder=3)
    ax.set_xscale("log", base=2)
    ax.set_yscale("log")
    ax.set_xticks(sorted({r["p"] for r in rows}))
    ax.get_xaxis().set_major_formatter("{x:.0f}")
    _style(ax, f"{family}: best time vs rank count, "
               f"msize={msize} (ranks as rows of one device)",
           "devices (p)", "best time (ms)")
    _legend(ax)
    path = os.path.join(outdir, f"scaling_{family}_p_m{msize}.png")
    fig.savefig(path, dpi=160, bbox_inches="tight", facecolor=SURFACE)
    plt.close(fig)
    return path


def fig_sort_throughput(records, outdir):
    import matplotlib.pyplot as plt
    rows = [r for r in records if r.get("kind") == "sort"
            and r.get("p") == 1 and r.get("distribution") == "uniform"]
    if not rows:
        return None
    # The shared headline cell rule (report.select_headline): latest
    # record wins, medians never displaced by legacy rows — one
    # implementation with the NORTHSTAR table so figure and table
    # cannot disagree.
    from icikit_torch.bench.report import select_headline
    by_alg = defaultdict(dict)
    chosen = select_headline(
        rows, key_of=lambda r: (r["algorithm"], r["n"]),
        proto_of=lambda r: r.get("protocol", "chained-best"))
    for (alg, n), r in chosen.items():
        by_alg[alg][n] = r["keys_per_s"]
    fig, ax = plt.subplots(figsize=(6.4, 4.0), facecolor=SURFACE)
    for alg in sorted(by_alg):
        pts = sorted(by_alg[alg].items())
        c = PALETTE[SORT_SLOTS.get(alg, 6)]
        ax.plot([n for n, _ in pts], [k / 1e6 for _, k in pts],
                color=c, linewidth=2, marker="o", markersize=5,
                label=alg, zorder=3)
    ax.set_xscale("log", base=2)
    _style(ax, "Distributed sorts: throughput vs input size "
               "(int32, uniform, one device)",
           "keys (n)", "throughput (M keys/s)")
    _legend(ax)
    path = os.path.join(outdir, "sort_throughput.png")
    fig.savefig(path, dpi=160, bbox_inches="tight", facecolor=SURFACE)
    plt.close(fig)
    return path


def fig_sort_scaling(records, outdir):
    """keys/s vs p for the four sorts: the reference's headline
    sorting figure (project3.pdf §4), the ranks rows of one device.
    Line style distinguishes input size (solid = largest)."""
    import matplotlib.pyplot as plt
    rows = [r for r in records
            if r.get("distribution") == "uniform" and r.get("p", 0) > 1
            and r.get("errors", 0) == 0]  # verified runs only
    if not rows:
        return None
    sizes = sorted({r["n"] for r in rows})[-2:]  # two largest n
    styles = {n: s for n, s in zip(sizes, ("--", "-"))}
    by_key = defaultdict(dict)
    for r in rows:
        if r["n"] not in styles:
            continue
        cur = by_key[(r["algorithm"], r["n"])].get(r["p"], 0)
        if r["keys_per_s"] > cur:
            by_key[(r["algorithm"], r["n"])][r["p"]] = r["keys_per_s"]
    fig, ax = plt.subplots(figsize=(6.4, 4.0), facecolor=SURFACE)
    for (alg, n) in sorted(by_key):
        pts = sorted(by_key[(alg, n)].items())
        c = PALETTE[SORT_SLOTS.get(alg, 6)]
        label = f"{alg} (n=2^{n.bit_length() - 1})"
        ax.plot([p for p, _ in pts], [k / 1e6 for _, k in pts],
                color=c, linewidth=2, linestyle=styles[n], marker="o",
                markersize=5, label=label, zorder=3)
    ax.set_xscale("log", base=2)
    ax.set_xticks(sorted({p for v in by_key.values() for p in v}))
    ax.get_xaxis().set_major_formatter("{x:.0f}")
    _style(ax, "Distributed sorts: throughput vs rank count "
               "(int32, uniform, ranks as rows of one device)",
           "devices (p)", "throughput (M keys/s)")
    _legend(ax)
    path = os.path.join(outdir, "sort_scaling_p.png")
    fig.savefig(path, dpi=160, bbox_inches="tight", facecolor=SURFACE)
    plt.close(fig)
    return path


# The H100 SXM's dense bf16 peak (NVIDIA's data sheet, a specification
# and not a measurement): a reading above it is a timing artifact, not
# a kernel.
_TFLOPS_CEILING = 989.0


def fig_longcontext(records, outdir):
    import matplotlib.pyplot as plt
    from icikit_torch.bench.report import select_headline
    rows = [r for r in records
            if r.get("verified")
            and r.get("impl") in ("flash", "flash_shift")
            and r["tflops"] <= _TFLOPS_CEILING]
    # shared headline cell rule (report.select_headline): the most
    # recent record per (impl, mode, d_head, seq), medians never
    # displaced by legacy rows
    chosen = select_headline(
        rows,
        key_of=lambda r: (r["impl"], r["mode"], r.get("d_head", 64),
                          r["seq"]),
        proto_of=lambda r: r.get("protocol", "chained-best"))
    series = {}  # (impl, mode, d_head) -> {seq: tflops}
    for (impl, mode, dh, seq), r in chosen.items():
        series.setdefault((impl, mode, dh), {})[seq] = r["tflops"]
    if not series:
        return None
    # color follows the (mode, d_head) entity; the const-shift variant
    # of an entity shares its color and dashes instead
    slots = {("fwd", 128): 0, ("fwdbwd", 128): 1,
             ("fwd", 64): 2, ("fwdbwd", 64): 3}
    names = {("fwd", 128): "fwd, d=128",
             ("fwdbwd", 128): "fwd+bwd, d=128",
             ("fwd", 64): "fwd, d=64",
             ("fwdbwd", 64): "fwd+bwd, d=64"}
    fig, ax = plt.subplots(figsize=(6.4, 4.0), facecolor=SURFACE)
    for key in sorted(series,
                      key=lambda k: (slots.get(k[1:], 6), k[0])):
        impl, mode, dh = key
        pts = sorted(series[key].items())
        c = PALETTE[slots.get((mode, dh), 6)]
        shift = impl == "flash_shift"
        label = names.get((mode, dh), f"{mode}, d={dh}")
        ax.plot([s for s, _ in pts], [t for _, t in pts], color=c,
                linewidth=2, linestyle="--" if shift else "-",
                marker="o", markersize=5,
                label=label + (" (const-shift)" if shift else ""),
                zorder=3)
    ax.set_xscale("log", base=2)
    ax.set_ylim(bottom=0)
    xs = sorted({s for v in series.values() for s in v})
    ax.set_xticks(xs)
    ax.set_xticklabels([f"{s//1024}k" for s in xs])
    _style(ax, "Causal flash attention: achieved TFLOP/s vs sequence "
               "(b=1, bf16, one device)",
           "sequence length (tokens)",
           "TFLOP/s (median; latest legacy reading where no median "
           "exists)")
    _legend(ax)
    path = os.path.join(outdir, "longcontext_tflops.png")
    fig.savefig(path, dpi=160, bbox_inches="tight", facecolor=SURFACE)
    plt.close(fig)
    return path


def render_all(outdir="docs/figs_torch", scaling="scaling_torch.jsonl",
               northstar="northstar_torch.jsonl",
               longcontext="longcontext_torch.jsonl",
               sort_scaling="sort_scaling_torch.jsonl"):
    import matplotlib
    matplotlib.use("Agg")
    from icikit_torch.bench.outputs import check_output
    check_output(outdir)
    os.makedirs(outdir, exist_ok=True)
    sc = _load(scaling)
    ns = _load(northstar)
    lc = _load(longcontext)
    ss = _load(sort_scaling)
    out = []
    out.append(fig_scaling_msize(sc, outdir, "allgather", p=8))
    out.append(fig_scaling_msize(sc, outdir, "alltoall", p=8))
    out.append(fig_scaling_p(sc, outdir, "allgather", msize=65536))
    out.append(fig_scaling_p(sc, outdir, "allreduce", msize=65536))
    out.append(fig_sort_throughput(ns, outdir))
    out.append(fig_sort_scaling(ss, outdir))
    out.append(fig_longcontext(lc, outdir))
    return [p for p in out if p]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--outdir", default="docs/figs_torch")
    args = ap.parse_args(argv)
    for p in render_all(args.outdir):
        print(p)
    return 0


if __name__ == "__main__":
    sys.exit(main())
