"""Per-tile cost accounting for the flash forward's tile loop.

The port of ``python -m icikit.bench.tile_floor``: the same six
variants over identical tile grids, so that the differences between
them decompose one tile's time into its pieces:

- ``full``: the port's production forward (``flash_fwd``, causal,
  online softmax; 128 x 128 tiles at these head dims), its time over
  the causal tiles, the diagonal included: ``flash_fwd``'s exact tile
  count;
- ``mxu``: both tile products and the least glue, no softmax
  statistics (``tile_mxu``, B17);
- ``softmax_ks1``, ``no_exp2``, ``no_max``, ``no_exp2_no_max``: the
  online-softmax loop with exp2 and/or the running max taken out
  (``tile_ablate``, B17), each over the full rectangle of tiles.

``tile_mxu`` and ``tile_ablate`` run ``flash_fwd``'s wgmma/TMA tile
loop at its geometry (``csrc/tile_floor.cu``), every variant counted in
its 128 x 128 tiles, so the differences say what exp2 and the running
max cost inside that loop, and ``full`` against ``softmax_ks1`` what
``flash_fwd``'s own loop (causal, its mask, lse) loses against the
study's. The card has no counterpart of the TPU kernel's ks banking:
the shipped arm is one online softmax. Each variant is timed by the
median-of-windows protocol over a chain (``out * 0.999`` fed back as
q), windows faster than the tiles' products at the card's nameplate
bf16 rate discarded. On the CPU (``--device cpu``) each variant runs its
plain version: per-tile times there are the CPU's, not the card's.

    python -m icikit_torch.bench.tile_floor --seq 32768 --dhead 64
    python -m icikit_torch.bench.tile_floor --device cpu --seq 256 \\
        --windows 1
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from icikit_torch.ops.cuda_tile_floor import (ablate_plain,  # noqa: F401
                                              mxu_plain)

# log2(e) as JAX's measure folds it into the scale (tile_floor.py:176)
LOG2E_JAX = 1.442695

# (variant, use_exp2, use_max) of the ablations, in JAX's order
ABLATIONS = (("softmax_ks1", True, True), ("no_exp2", False, True),
             ("no_max", True, False), ("no_exp2_no_max", False, False))


def tile_ops(bq: int, bk: int, d: int) -> int:
    """Operations of one tile: the two products, 2 bq bk d each."""
    return 4 * bq * bk * d


def measure(seq: int, d: int = 64, h: int = 8, windows: int = 3,
            device: str = "cuda") -> list[dict]:
    """The six variants' records at ``(1, h, seq, d)`` bf16 (q, k, v
    from a seeded generator on ``device``), over the kernels' 128 x 128
    tiles (``seq`` a multiple of 128). On the card the kernels take head
    dims 64 and 128, and raise otherwise."""
    from icikit_torch.bench.headline import device_identity
    from icikit_torch.bench.train import detect_peak
    from icikit_torch.ops import cuda_attention, cuda_tile_floor
    from icikit_torch.utils.timing import timeit_windows

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the "
                           "plain versions on the CPU")
    b = 1
    scale = d ** -0.5
    gen = torch.Generator(device=device).manual_seed(0)
    q, k, v = (torch.randn((b, h, seq, d), generator=gen, device=device)
               .to(torch.bfloat16) for _ in range(3))
    tile = cuda_tile_floor.TILE
    rect_tiles = b * h * (seq // tile) ** 2
    peak = detect_peak(device)
    name, power = device_identity(device)
    records = []

    def add(variant, fn, tiles):
        floor = tiles * tile_ops(tile, tile, d) / peak if peak else None
        res = timeit_windows(
            fn, (q, k, v), lambda a, out: (out * 0.999, a[1], a[2]),
            windows=windows, runs=2, warmup=1, floor_s=floor)
        records.append({
            "kind": "tile_floor", "variant": variant, "seq": seq, "d": d,
            "bq": tile, "bk": tile, "tiles": tiles,
            "median_s": res.median_s, "spread_s": [res.min_s, res.max_s],
            # unrounded: a tile takes nanoseconds on the card
            "per_tile_us": res.median_s / tiles * 1e6,
            "session_quality": res.session_quality(),
            "device": name, "power_limit": power})

    # the causal forward's work in the study's tiles (flash_fwd's at
    # these head dims): the lower triangle, the diagonal included
    add("full", lambda q, k, v: cuda_attention.flash_fwd(q, k, v, True,
                                                          scale)[0],
        b * h * sum(iq + 1 for iq in range(seq // tile)))
    scale_log2 = scale * LOG2E_JAX
    add("mxu", lambda q, k, v: cuda_tile_floor.tile_mxu(q, k, v, scale_log2),
        rect_tiles)
    for variant, use_exp2, use_max in ABLATIONS:
        add(variant, lambda q, k, v, e=use_exp2, m=use_max:
            cuda_tile_floor.tile_ablate(q, k, v, scale_log2, e, m),
            rect_tiles)
    return records


def render(records) -> str:
    """JAX's decomposition, per tile in nanoseconds (the port's tiles are
    128 x 128, JAX's 1024 x 1024)."""
    ns = {r["variant"]: r["per_tile_us"] * 1e3 for r in records}
    full = next(r for r in records if r["variant"] == "full")
    sm = ns["softmax_ks1"]
    lines = [
        f"seq={full['seq']} d={full['d']} (bq={full['bq']}, "
        f"bk={full['bk']}):",
        f"  mxu-only        {ns['mxu']:.3f} ns/tile "
        f"(dots + glue only — the measured product floor)",
        f"  softmax ks=1    {sm:.3f} ns/tile (full dataflow, single bank)",
        f"  - exp2          {ns['no_exp2']:.3f} "
        f"(exposed exp2 cost {sm - ns['no_exp2']:+.3f})",
        f"  - rowmax        {ns['no_max']:.3f} "
        f"(exposed max-chain cost {sm - ns['no_max']:+.3f})",
        f"  - both          {ns['no_exp2_no_max']:.3f}",
        f"  shipped (flash_fwd causal) {ns['full']:.3f} ns/tile "
        f"(vs softmax ks=1: {sm - ns['full']:+.3f})",
    ]
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seq", type=int, default=32768)
    ap.add_argument("--dhead", type=int, default=64)
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--json", dest="json_path", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    records = measure(args.seq, d=args.dhead, windows=args.windows,
                      device=args.device)
    for r in records:
        print(json.dumps(r))
    print(render(records), file=sys.stderr)
    if args.json_path:
        # append: record files accumulate across invocations
        with open(args.json_path, "a") as f:
            for r in records:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
