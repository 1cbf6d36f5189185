"""Predicted bitonic/quicksort crossover on a real parallel fabric.

The port of ``icikit/bench/crossover.py``. The reference measured its
sorting study to 128 ranks and found hypercube quicksort the best
*trend* at large p while bitonic led at moderate p
(``Parallel-Sorting/Data/project3.pdf`` p.5 §4). One card holds at most
a handful of ranks, so this module *predicts* the crossover from
quantities the port owns:

- **Schedule structure**: exact per-(algorithm, p) communication
  rounds and per-rank bytes, counted from the shipped programs
  (``schedule_stats.analyze_sort``).
- **Compute rates**, measured on an H100 by the port: the comparator
  rate from the one-rank sort of 2^28 int32 keys (``chip_smoke.py``
  phase 4), the merge-pass rate from :func:`measure_merge_rate`.
- **Fabric constants**: the per-rank bandwidth B from the H100 SXM's
  NVLink 4 specification and the per-round latency α swept over 1, 5
  and 25 µs, since launch and sync latency is the least certain
  constant.

Model, per rank (critical path), n_loc = n/p keys of s bytes:

  T_alg(p) = local_sort + work_rounds · n_loc/R_merge
             + rounds · α + bytes_dev / B

where local_sort = n_loc·log2(n_loc)/R_cmp and ``work_rounds`` is the
merge or partition work attached to each communication round (bitonic:
a full-block merge a round; quicksort: a partition scan a round;
sample: the splitter machinery counted in its rounds), the reference's
§3 cost form with the schedule terms counted rather than assumed.

CLI::

    python -m icikit_torch.bench.crossover --n 1048576 \\
        --json crossover_torch.jsonl
"""

from __future__ import annotations

import argparse
import json
import math
import sys

# The H100's constants (overridable by the CLI and the arguments):
# R_CMP: comparator operations a second of the port's one-rank sort,
#   2^28 int32 keys, 2^28 · 28 / 28.04-28.20 ms (chip_smoke.py phase 4,
#   the median, three runs; NVIDIA H100 80GB HBM3, 700.00 W).
R_CMP = 2.67e11
# R_MERGE: keys a second of one compare-split pass, 2^22 int32 keys in
#   0.106-0.130 ms, 3.2e10-3.9e10 keys/s (measure_merge_rate in
#   chip_smoke.py phase 31, three runs; NVIDIA H100 80GB HBM3, 700.00 W).
R_MERGE = 3.6e10
# B_LINK: bytes a second a rank sends, a specification and not a
#   measurement: NVLink 4 on the H100 SXM, 450 GB/s a direction a GPU,
#   less 10% for protocol overhead as the JAX package derates its fabric.
B_LINK = 405.0e9
ALPHAS_US = (1.0, 5.0, 25.0)
DEFAULT_JSON = "crossover_torch.jsonl"

_TRACE_CACHE: dict = {}


def _traced(alg: str, p: int, n: int):
    # cached: the count is alpha-independent (bitonic at p = 1024 runs
    # 55 full-block rounds)
    key = (alg, p, n)
    if key not in _TRACE_CACHE:
        from icikit_torch.bench.schedule_stats import analyze_sort
        st = analyze_sort(alg, p, n)
        _TRACE_CACHE[key] = (st.rounds, st.bytes_per_dev)
    return _TRACE_CACHE[key]


def predict_time(alg: str, p: int, n: int, alpha_s: float,
                 r_cmp: float | None = None, r_merge: float | None = None,
                 b_link: float | None = None) -> float:
    """Modeled wall seconds for one distributed sort at (p, n); the
    byte volumes (and with them the key dtype) come from the count.
    The rates default to the module's constants as they stand."""
    r_cmp = R_CMP if r_cmp is None else r_cmp
    r_merge = R_MERGE if r_merge is None else r_merge
    b_link = B_LINK if b_link is None else b_link
    n_loc = max(1, n // p)
    rounds, bytes_dev = _traced(alg, p, n)
    local = n_loc * max(math.log2(n_loc), 1.0) / r_cmp
    work = rounds * n_loc / r_merge
    comm = rounds * alpha_s + bytes_dev / b_link
    return local + work + comm


def alpha_key(a_us) -> str:
    """The string key a given α is filed under in ``crossover_table``
    (``f"{a_us:g}"``: 1.0 and 1 collapse to "1")."""
    return f"{float(a_us):g}"


def comparator_rate(n: int, seconds: float) -> float:
    """Comparator operations a second implied by sorting n keys in
    ``seconds`` (n log2 n of them): how R_CMP is read off a sort."""
    return n * math.log2(n) / seconds


# R_MERGE sensitivity factors: how far each crossover verdict leans on
# the merge-rate constant, beside the α sweep.
R_MERGE_FACTORS = (0.5, 1.0, 2.0)


def measure_merge_rate(n: int = 1 << 22, dtype: str = "int32",
                       device: str = "cuda") -> dict:
    """Measured merge-pass rate (keys/s) of the shipped compare-split:
    one pass is ``ops.merge.compare_split_min`` over an ``n``-key block
    (on the card the sort kernels' merge-only pass, B2), one round's
    merge work in the model's ``rounds · n_loc / R_merge`` term. Timed
    chained: the kept half, plus one, feeds the next pass, so no two
    passes are value-identical. The record names the device."""
    import torch

    from icikit_torch.bench.headline import device_identity
    from icikit_torch.ops.merge import compare_split_min
    from icikit_torch.utils.timing import timeit_chained

    gen = torch.Generator(device="cpu").manual_seed(0)
    dt = getattr(torch, dtype)
    a, b = (torch.sort(torch.randint(0, 1 << 30, (n,), generator=gen,
                                     dtype=dt)).values.to(device)
            for _ in range(2))
    res = timeit_chained(compare_split_min, (a, b),
                         lambda args, out: (out + 1, args[1]),
                         runs=3, warmup=2)
    name, power = device_identity(device)
    return {
        "r_merge_measured_keys_per_s": n / res.mean_s,
        "r_merge_bench_n": n,
        "r_merge_bench_backend": name,
        "r_merge_bench_power_limit": power,
        "r_merge_bench_ms": res.mean_s * 1e3,
    }


def crossover_table(n: int, ps=None,
                    incumbent: str = "bitonic",
                    challenger: str = "quicksort",
                    alphas_us=ALPHAS_US) -> dict:
    """Times per (alpha, alg, p) plus, per alpha, the first p where
    ``challenger`` undercuts ``incumbent`` (None if never within
    ``ps``). The per-α maps (``times``, ``crossover_p``) are keyed by
    strings (:func:`alpha_key`), so the table and its JSON line have
    the same shape."""
    if ps is None:
        ps = tuple(2 ** k for k in range(1, 11))  # 2..1024
    algs = (incumbent, challenger)
    out = {"n": n, "ps": list(ps), "algs": list(algs),
           "incumbent": incumbent, "challenger": challenger,
           "times": {}, "crossover_p": {},
           # crossover_p again with R_MERGE scaled by each factor: how
           # much every verdict leans on the merge-rate constant
           "r_merge_factors": list(R_MERGE_FACTORS),
           "crossover_p_rmerge": {}}

    def first_cross(times):
        for i, p in enumerate(ps):
            if times[challenger][i] < times[incumbent][i]:
                return p
        return None

    for a_us in alphas_us:
        times = {alg: [predict_time(alg, p, n, a_us * 1e-6)
                       for p in ps] for alg in algs}
        out["times"][alpha_key(a_us)] = times
        cross = first_cross(times)
        out["crossover_p"][alpha_key(a_us)] = cross
        sens = {}
        for f in R_MERGE_FACTORS:
            if f == 1.0:    # the baseline table already computed it
                sens[f"{f:g}"] = cross
                continue
            tf = {alg: [predict_time(alg, p, n, a_us * 1e-6,
                                     r_merge=R_MERGE * f)
                        for p in ps] for alg in algs}
            sens[f"{f:g}"] = first_cross(tf)
        out["crossover_p_rmerge"][alpha_key(a_us)] = sens
    return out


def render_markdown(tab: dict) -> str:
    n = tab["n"]
    inc = tab.get("incumbent", "bitonic")
    ch = tab.get("challenger", "quicksort")
    lines = [
        f"## Predicted {inc}/{ch} crossover on an NVLink fabric",
        "",
        f"> Cost model T(p) = local_sort + rounds·(n/p)/R_merge + "
        f"rounds·α + bytes_dev/B with the schedule terms counted from "
        f"the shipped programs (exact rounds and per-rank bytes per "
        f"(algorithm, p)), compute rates measured by the port on an "
        f"H100 (R_cmp = {R_CMP / 1e9:.0f} G cmp/s, R_merge = "
        f"{R_MERGE / 1e9:.0f} Gkeys/s) and B = {B_LINK / 1e9:.0f} GB/s, "
        f"the NVLink 4 specification derated 10% (not measured); α is "
        f"the per-round launch and sync latency, the least certain "
        f"constant, so the prediction is quoted across α. n = "
        f"2^{n.bit_length() - 1} int32.",
        "",
        "| α (µs) | " + " | ".join(f"p={p}" for p in tab["ps"])
        + " | crossover |",
        "|---|" + "---|" * (len(tab["ps"]) + 1),
    ]

    # winner tags must be distinct (sample and sample_bitonic share a
    # first letter): word initials when the initials collide
    def tag(alg):
        if inc[0] != ch[0]:
            return alg[0]
        return "".join(w[0] for w in alg.split("_"))

    for a_key, times in tab["times"].items():
        cells = []
        for i in range(len(tab["ps"])):
            ti = times[inc][i] * 1e3
            tc = times[ch][i] * 1e3
            win = tag(ch) if tc < ti else tag(inc)
            cells.append(f"{ti:.2f}/{tc:.2f} {win}")
        cr = tab["crossover_p"][a_key]
        tail = f" **p = {cr}** |" if cr else " — |"
        lines.append(f"| {a_key} | " + " | ".join(cells) + " |" + tail)
    cross_desc = ", ".join(
        (f"p={cr} at {a_key} µs" if cr else f"none ≤ {tab['ps'][-1]} "
         f"at {a_key} µs")
        for a_key, cr in tab["crossover_p"].items())
    lines += [
        "",
        f"Cells are modeled ms {inc}/{ch} with the winner tagged; the "
        f"crossover column is the first p where {ch} undercuts {inc} "
        f"(computed: {cross_desc}).",
        "",
    ]
    sens = tab.get("crossover_p_rmerge")
    if sens:
        lines += [
            "### R_MERGE sensitivity",
            "",
            "> crossover p again with the merge-rate constant scaled "
            "×0.5/×1/×2, the same treatment α gets. A verdict that holds "
            "across a 4× R_MERGE range does not lean on the constant.",
            "",
            "| α (µs) | " + " | ".join(
                f"R_MERGE×{f:g}" for f in tab["r_merge_factors"]) + " |",
            "|---|" + "---|" * len(tab["r_merge_factors"]),
        ]
        for a_key, row in sens.items():
            cells = [str(row[f"{f:g}"]) if row[f"{f:g}"] else "—"
                     for f in tab["r_merge_factors"]]
            lines.append(f"| {a_key} | " + " | ".join(cells) + " |")
        lines.append("")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--pair", default="bitonic,quicksort",
                    metavar="INCUMBENT,CHALLENGER",
                    help="which two sorts to compare (any of the four; "
                         "the reference's own headline pair is "
                         "sample,sample_bitonic, project3.pdf §4)")
    ap.add_argument("--calibrate-merge", action="store_true",
                    help="run the merge-pass microbench on --device and "
                         "put the measured rate, with the device's "
                         "name, into the record")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", dest="json_path", default=DEFAULT_JSON,
                    help="append the table as a JSON line here "
                         "('' to skip)")
    args = ap.parse_args(argv)
    if args.json_path:
        from icikit_torch.bench.outputs import check_output
        check_output(args.json_path)
    inc, ch = (s.strip() for s in args.pair.split(","))
    tab = crossover_table(args.n, incumbent=inc, challenger=ch)
    if args.calibrate_merge:
        tab.update(measure_merge_rate(device=args.device))
        print(f"measured merge-pass rate: "
              f"{tab['r_merge_measured_keys_per_s'] / 1e9:.2f} Gkeys/s "
              f"({tab['r_merge_bench_backend']}, "
              f"n=2^{tab['r_merge_bench_n'].bit_length() - 1}) vs "
              f"model R_MERGE = {R_MERGE / 1e9:.0f} Gkeys/s\n")
    print(render_markdown(tab))
    if args.json_path:
        with open(args.json_path, "a") as f:
            f.write(json.dumps(tab) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
