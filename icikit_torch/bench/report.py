"""Benchmark report renderer — the reference's PDF studies as markdown (C29).

The port's copy of ``icikit/bench/report.py`` (host-only Python), for
the records of ``icikit_torch.bench.harness`` and the north-star
report. The ``xla`` variant is the vendor baseline: PyTorch's own op
over the rank axis in the port.

The reference published two benchmark reports as PDFs of bitmap figures
(``Communication/Data/report.pdf``: time-vs-msize at fixed p and
time-vs-p at fixed msize, Figs. 2-6; ``Parallel-Sorting/Data/
project3.pdf``: sort scaling study). This module renders the same views
from machine-readable ``BenchRecord`` dicts (``bench.harness``):
per-family time-vs-msize tables, time-vs-p strong-scaling tables, and
a best-algorithm ranking against the "vendor" baseline — the
reference's qualitative conclusions (report.pdf p.3 §2.4), recomputed
instead of eyeballed.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict


# Below this, a measurement is noise: an identity program (p=1), a
# cached replay, or a two-point subtraction that collapsed. Excluded
# from rankings; rendered as "<1".
MIN_MEASURABLE_S = 1e-6


def _fmt_time(s: float) -> str:
    if s < MIN_MEASURABLE_S:
        return "<1"
    return f"{s * 1e6:,.1f}"


def _table(headers, rows) -> str:
    lines = ["| " + " | ".join(headers) + " |",
             "|" + "|".join("---" for _ in headers) + "|"]
    for row in rows:
        lines.append("| " + " | ".join(str(c) for c in row) + " |")
    return "\n".join(lines)


def _pivot_table(records, family, fixed_key, fixed_val, row_key,
                 row_label, caption) -> str:
    """Algorithms as columns, ``row_key`` values as rows, best µs cells
    (unverified results flagged ✗)."""
    recs = [r for r in records
            if r["family"] == family and r[fixed_key] == fixed_val]
    algs = sorted({r["algorithm"] for r in recs})
    cell = {(r[row_key], r["algorithm"]): r for r in recs}
    rows = []
    for rv in sorted({r[row_key] for r in recs}):
        row = [rv]
        for a in algs:
            r = cell.get((rv, a))
            row.append(_fmt_time(r["best_s"]) +
                       ("" if r["verified"] else " ✗") if r else "—")
        rows.append(row)
    return (f"### {family}: {caption}\n\n"
            + _table([row_label] + list(algs), rows))


def _time_vs_msize(records, family, p) -> str:
    """Fig. 2/5 analog: rows = msize, columns = algorithms (best µs)."""
    return _pivot_table(records, family, "p", p, "msize", "msize (elems)",
                        f"best time (µs) vs message size, p={p}")


def _time_vs_p(records, family, msize) -> str:
    """Fig. 3/6 analog: rows = p, columns = algorithms (best µs)."""
    return _pivot_table(records, family, "msize", msize, "p", "p",
                        f"best time (µs) vs device count, msize={msize}")


def _ranking(records, family) -> str:
    """The reference's conclusion section: which algorithm wins where,
    and how the hand-rolled variants compare to the vendor baseline."""
    recs = [r for r in records if r["family"] == family and r["verified"]]
    if not recs:
        return ""
    wins = defaultdict(int)
    vs_xla = []
    by_config = defaultdict(list)
    for r in recs:
        by_config[(r["p"], r["msize"])].append(r)
    for cfg, rs in sorted(by_config.items()):
        if any(r["best_s"] < MIN_MEASURABLE_S for r in rs):
            # one unmeasurable entry poisons the whole comparison at
            # this config: dropping just that record would crown a
            # slower survivor as the winner
            continue
        best = min(rs, key=lambda r: r["best_s"])
        wins[best["algorithm"]] += 1
        xla = next((r for r in rs if r["algorithm"] == "xla"), None)
        if xla is not None and best["algorithm"] != "xla":
            vs_xla.append(xla["best_s"] / best["best_s"])
    lines = [f"### {family}: ranking\n"]
    total = sum(wins.values())
    for alg, w in sorted(wins.items(), key=lambda kv: -kv[1]):
        lines.append(f"- **{alg}** fastest in {w}/{total} configurations")
    if vs_xla:
        import statistics
        lines.append(
            f"- where a hand-rolled schedule beat the vendor baseline, it "
            f"was {statistics.median(vs_xla):.2f}x faster (median)")
    return "\n".join(lines)


def fit_cost_models(records: list[dict], family: str) -> list[dict]:
    """Fit the reference's α-β communication cost models per algorithm
    (``report.pdf`` §§2.2-2.4, asserted there analytically; here fitted
    to the measured sweep and judged by residual):

    - ``linear``:  t = ts·(p−1) + tw·m·(p−1)  — ring / e-cube /
      wraparound / naive (one fixed-size exchange per step, p−1 steps);
    - ``log``:     t = ts·⌈log2 p⌉ + tw·m·(p−1) — recursive doubling /
      hypercube / binomial (log p rounds, total volume m·(p−1)).

    Least squares on *relative* error (rows weighted by 1/t), so the
    latency regime (small m) and the bandwidth regime (large m) count
    equally — exactly the two terms the models separate. Returns one
    dict per (algorithm, model): fitted ts (s), tw (s/byte), and the
    relative RMS residual. Fits use only records with p > 1 and a
    measurable time; an algorithm needs >= 4 such points across >= 2
    device counts, else it is skipped.
    """
    import numpy as np

    out = []
    recs = [r for r in records
            if r["family"] == family and r["p"] > 1
            and r["best_s"] >= MIN_MEASURABLE_S]
    for alg in sorted({r["algorithm"] for r in recs}):
        rows = [r for r in recs if r["algorithm"] == alg]
        if len(rows) < 4 or len({r["p"] for r in rows}) < 2:
            continue
        t = np.array([r["best_s"] for r in rows])
        p_ = np.array([r["p"] for r in rows], dtype=np.float64)
        m = np.array([r["bytes_per_block"] for r in rows],
                     dtype=np.float64)
        for model, lat in (("linear", p_ - 1),
                           ("log", np.ceil(np.log2(p_)))):
            A = np.stack([lat, m * (p_ - 1)], axis=1)
            w = 1.0 / t
            Aw, tw_vec = A * w[:, None], t * w
            coef, *_ = np.linalg.lstsq(Aw, tw_vec, rcond=None)
            # ts and tw are physical constants (latency, 1/bandwidth):
            # a negative coefficient is the 2-parameter fit soaking up
            # curvature — refit with it pinned to zero instead of
            # publishing a negative latency
            for j in (0, 1):
                if coef[j] < 0:
                    k = 1 - j
                    c = (float(Aw[:, k] @ tw_vec)
                         / float(Aw[:, k] @ Aw[:, k]))
                    coef = np.zeros(2)
                    coef[k] = max(c, 0.0)
                    break
            ts, tw = float(coef[0]), float(coef[1])
            pred = A @ coef
            rel_rms = float(np.sqrt(np.mean(((pred - t) / t) ** 2)))
            out.append({"family": family, "algorithm": alg,
                        "model": model, "ts_s": ts, "tw_s_per_byte": tw,
                        "rel_rms": rel_rms, "n_points": len(rows)})
    return out


def _cost_model_section(records, family) -> str:
    fits = fit_cost_models(records, family)
    if not fits:
        return ""
    rows = []
    by_alg = defaultdict(list)
    for f in fits:
        by_alg[f["algorithm"]].append(f)
    for alg, fs in sorted(by_alg.items()):
        best = min(fs, key=lambda f: f["rel_rms"])
        for f in sorted(fs, key=lambda f: f["model"]):
            mark = " ◀" if f is best and len(fs) > 1 else ""
            rows.append([
                alg,
                ("ts·(p−1) + tw·m·(p−1)" if f["model"] == "linear"
                 else "ts·⌈log p⌉ + tw·m·(p−1)") + mark,
                f"{f['ts_s'] * 1e6:,.1f}",
                f"{f['tw_s_per_byte'] * 1e9:.3f}",
                f"{f['rel_rms']:.2f}",
                f["n_points"],
            ])
    return (f"### {family}: fitted α-β cost models\n\n"
            "The reference asserted these forms analytically "
            "(report.pdf §§2.2-2.4); fitted here by relative least "
            "squares over the full (p, msize) sweep. ◀ marks the "
            "better-fitting form per algorithm; ts = per-step latency, "
            "tw = per-byte transfer time, rel RMS = relative residual "
            "(0 = exact fit).\n\n"
            + _table(["algorithm", "model", "ts (µs)", "tw (ns/B)",
                      "rel RMS", "points"], rows))


def render_report(records: list[dict], title: str = "Benchmark report",
                  heading_level: int = 1) -> str:
    """Render the full markdown report for a list of record dicts.

    Records from a 1-device mesh are excluded from every table and
    ranking: a p=1 collective is the identity program, so its timings
    are dispatch noise and any algorithm comparison built on them is
    meaningless (VERDICT r1 weak #1). Such records are summarized by a
    verified-degenerate count instead.
    """
    out = [f"{'#' * heading_level} {title}\n"]
    degenerate = [r for r in records if r["p"] == 1]
    records = [r for r in records if r["p"] != 1]
    if degenerate:
        n_ok = sum(1 for r in degenerate if r.get("verified", True))
        out.append(
            f"> {n_ok}/{len(degenerate)} p=1 configurations executed "
            "and verified (identity programs — timings suppressed; a "
            "comparison needs a mesh).")
    families = sorted({r["family"] for r in records})
    for fam in families:
        frecs = [r for r in records if r["family"] == fam]
        for p in sorted({r["p"] for r in frecs}):
            out.append(_time_vs_msize(records, fam, p))
        ps = {r["p"] for r in frecs}
        if len(ps) > 1:  # strong-scaling view only when p varies
            for m in sorted({r["msize"] for r in frecs}):
                out.append(_time_vs_p(records, fam, m))
            section = _cost_model_section(records, fam)
            if section:
                out.append(section)
        rank = _ranking(records, fam)
        if rank:
            out.append(rank)
    unverified = [r for r in records if not r.get("verified", True)]
    if unverified:
        out.append(f"**WARNING: {len(unverified)} unverified results "
                   f"(marked ✗).**")
    return "\n\n".join(out) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("records", help="JSON-lines file of BenchRecords")
    ap.add_argument("--out", default=None, help="output markdown path")
    ap.add_argument("--title", default="Benchmark report")
    args = ap.parse_args(argv)
    with open(args.records) as f:
        records = [json.loads(line) for line in f if line.strip()]
    text = render_report(records, title=args.title)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    else:
        try:
            print(text)
        except BrokenPipeError:  # e.g. `| head` closed the pipe
            return 0
    return 0


if __name__ == "__main__":
    sys.exit(main())


def select_headline(rows, key_of, proto_of):
    """The shared headline cell rule for every table AND figure
    rendered from accumulated records: latest record wins per cell,
    except a median-of-windows record is never displaced by a
    non-median (legacy best-of/chained) one. One implementation so a
    table and the figure beside it can never disagree — best-of across
    sessions is banned from headlines (it keeps corrupted-fast
    windows).

    ``key_of(row) -> hashable cell key``; ``proto_of(row) -> str``
    (the record's protocol tag, "median-of-windows" or legacy).
    Returns {cell key: chosen row} preserving the input's append
    order semantics.
    """
    chosen = {}
    for r in rows:
        k = key_of(r)
        cur = chosen.get(k)
        r_med = proto_of(r) == "median-of-windows"
        cur_med = cur is not None and proto_of(cur) == "median-of-windows"
        if cur is None or r_med or not cur_med:
            chosen[k] = r
    return chosen
