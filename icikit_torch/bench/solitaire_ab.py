"""The peg-solitaire DFS kernel (I2) from two ``solitaire.cu`` sources,
timed in turns on one card.

Builds ``solitaire.cu`` from each of two source directories (with the
headers beside it) with ``nvcc`` (for ``sm_90a``, ``-Xptxas -v``)
through ``ops._build.build_sources`` into ``icikit_torch/build/ab/``,
then launches each library's ``icikit_solve_dfs`` on the same boards in
turns A, B, B, A: ``--reps`` launches timed by CUDA events, each after
an untimed one (``flash_ab.event_ms``), a case at a time. The cases: the study's three full-size
batches (``generate_dataset`` at seed 0: 20,000 easy, 20,000 medium,
1,000 hard boards, ``max_steps`` 500,000), and two probes of one step's
cost: the lone lane (the first hard board that hits the cap, alone in a
one-board launch: a single lane's chain) and the full warp (the first 32
capped hard boards, one warp: the chain with the lanes in every phase).

B's five outputs are held bit for bit to A's in every case; a departure
marks the summary ``"ok": false`` and exits 1 unless ``--timing-only``.

Prints one JSON line a turn, then one a source: its median ms a case,
ns and cycles a step of the slowest board (ms over the most steps any
board took, cycles at the SM clock read during the run), and its
kernel's registers, shared bytes and spill bytes from ptxas; then the
card's name, power limit and SM clock (``nvidia-smi``, read while the
lone-lane probe runs). ``--sass DIR`` also writes each library's SASS
(``cuobjdump -sass``) to ``DIR/solitaire_A.sass`` and ``_B.sass``.
Needs a CUDA card. A is usually the parent's source:

    mkdir -p _checkout/parent && git show HEAD~1:icikit_torch/csrc/\\
solitaire.cu > _checkout/parent/solitaire.cu
    python -m icikit_torch.bench.solitaire_ab --a _checkout/parent \\
        --b icikit_torch/csrc --sass _checkout/sass
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess

import numpy as np
import torch

from icikit_torch.ops import _build

FULL = (("easy", 20_000), ("medium", 20_000), ("hard", 1_000))
MAX_STEPS = 500_000
WARP = 32


def sass(lib_path: str) -> str:
    """``cuobjdump -sass`` of a built library."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_build.nvcc_path()), "cuobjdump")
    return subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()


class Case:
    """One launch's boards on the card and its output buffers a side."""

    def __init__(self, name: str, pegs: np.ndarray, playable: np.ndarray):
        self.name = name
        self.n = len(pegs)
        self.pegs, self.playable = (
            torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).cuda()
            for a in (pegs, playable))
        self.out = {}

    def outputs(self, side: str) -> list:
        if side not in self.out:
            n, dev = self.n, self.pegs.device
            self.out[side] = [
                torch.empty(n, dtype=torch.uint8, device=dev),
                torch.empty(n, dtype=torch.int32, device=dev),
                torch.empty((n, 25), dtype=torch.int32, device=dev),
                torch.empty(n, dtype=torch.int32, device=dev),
                torch.empty(n, dtype=torch.int32, device=dev)]
        return self.out[side]

    def call(self, lib, side: str):
        args = (self.pegs.data_ptr(), self.playable.data_ptr(), self.n,
                MAX_STEPS, *(o.data_ptr() for o in self.outputs(side)),
                torch.cuda.current_stream().cuda_stream)
        return lambda: _build.check(lib.icikit_solve_dfs(*args), "solve_dfs")


def cases() -> list:
    """The three full-size batches and the two probes, whose boards are
    the first hard boards that hit the cap (found by the native host
    solver)."""
    from icikit_torch.models.solitaire.dataset import generate_dataset
    from icikit_torch.models.solitaire.scheduler import solve_host

    out, hard = [], None
    for grade, n in FULL:
        b = generate_dataset(n, grade, seed=0)
        out.append(Case(f"{grade} {n}", b.pegs, b.playable))
        if grade == "hard":
            hard = b
    capped = np.flatnonzero(
        solve_host(hard, max_steps=MAX_STEPS).steps >= MAX_STEPS)
    if len(capped) < WARP:
        raise RuntimeError(f"only {len(capped)} hard boards hit the cap")
    for name, idx in (("lone lane", capped[:1]), ("full warp",
                                                  capped[:WARP])):
        out.append(Case(name, hard.pegs[idx], hard.playable[idx]))
    return out


def sm_clock(fn, ms: float, busy_ms: float = 2000.0) -> str:
    """The SM clock ``nvidia-smi`` reads while calls of ``fn`` (``ms``
    each) keep the card busy for about ``busy_ms``."""
    for _ in range(max(4, int(busy_ms / max(ms, 1e-3)))):
        fn()
    clock = smi("clocks.sm")
    torch.cuda.synchronize()
    return clock


def run(a_dir: str, b_dir: str, reps: int = 3,
        sass_dir: str | None = None) -> bool:
    """Time and compare the two sources; whether B's outputs equal A's
    on every case."""
    from icikit_torch.bench.flash_ab import _ptxas_regs, event_ms
    from icikit_torch.utils.timing import _median

    flags = ("-Xptxas", "-v")
    srcs = {s: os.path.join(d, "solitaire.cu")
            for s, d in (("A", a_dir), ("B", b_dir))}
    out_dir = os.path.join(_build.BUILD_DIR, "ab")
    built = _build.build_sources("solitaire", srcs, out_dir, flags)
    libs = {s: lib for s, (lib, _) in built.items()}
    info = {}
    for s, (_, log) in built.items():
        kern = _ptxas_regs(log, lambda k: "solve_dfs" in k, shared=True)
        info[s] = dict(zip(("registers", "spill_bytes", "shared_bytes"),
                           next(iter(kern.values()), ())))
        if sass_dir:
            os.makedirs(sass_dir, exist_ok=True)
            path = _build._target("solitaire", srcs[s], out_dir, flags)[1]
            with open(os.path.join(sass_dir, f"solitaire_{s}.sass"),
                      "w") as f:
                f.write(sass(path))
    work = cases()
    times = {s: {c.name: [] for c in work} for s in "AB"}
    clocks = []
    for turn, s in enumerate("ABBA"):
        for c in work:
            fn = c.call(libs[s], s)
            times[s][c.name] += [event_ms(fn, 1) for _ in range(reps)]
        lone = next(c for c in work if c.name == "lone lane")
        clocks.append(sm_clock(lone.call(libs[s], s),
                               times[s][lone.name][-1]))
        print(json.dumps({"turn": turn, "source": s,
                          "ms": {c.name: times[s][c.name][-reps:]
                                 for c in work}, "sm_clock": clocks[-1]}),
              flush=True)
    same = {}
    for c in work:
        a, b = c.outputs("A"), c.outputs("B")
        same[c.name] = all(bool(torch.equal(x, y)) for x, y in zip(a, b))
    mhz = [float(x.split()[0]) for x in clocks if x]
    hz = _median(mhz) * 1e6 if mhz else None
    for s, d in (("A", a_dir), ("B", b_dir)):
        rows = {}
        for c in work:
            ms = _median(times[s][c.name])
            most = int(c.outputs(s)[3].max())
            row = {"ms": ms, "windows_ms": times[s][c.name],
                   "boards": c.n, "most_steps": most,
                   "ns_a_step": ms * 1e6 / most}
            if hz:
                row["cycles_a_step"] = ms * 1e-3 * hz / most
            rows[c.name] = row
        print(json.dumps({"source": s, "dir": d, "max_steps": MAX_STEPS,
                          "cases": rows, "ptxas": info[s]}), flush=True)
    ok = all(same.values())
    print(json.dumps({"b_equal_to_a": same, "sm_clock_mhz": mhz,
                      "ok": ok}), flush=True)
    print(smi("name,power.limit"), flush=True)
    return ok


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--a", required=True,
                   help="directory of arm A's solitaire.cu")
    p.add_argument("--b", required=True, help="the same for arm B")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--sass", default=None,
                   help="directory for each library's cuobjdump -sass")
    p.add_argument("--timing-only", action="store_true",
                   help="exit 0 even where B's outputs depart from A's")
    args = p.parse_args(argv)
    missing = [os.path.join(d, "solitaire.cu") for d in (args.a, args.b)
               if not os.path.isfile(os.path.join(d, "solitaire.cu"))]
    if missing:
        p.error(f"missing sources: {missing}")
    if not torch.cuda.is_available():
        raise SystemExit("solitaire_ab needs a CUDA card")
    ok = run(args.a, args.b, args.reps, args.sass)
    return 0 if ok or args.timing_only else 1


if __name__ == "__main__":
    raise SystemExit(main())
