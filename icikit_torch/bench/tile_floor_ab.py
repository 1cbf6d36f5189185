"""The tile-floor study's kernels (B17, ``tile_mxu`` and the four
``tile_ablate`` variants) of two ``tile_floor.cu`` sources, timed in
turns on one card.

Builds each arm's ``tile_floor.cu`` (with the headers beside it) with
``nvcc`` (for ``sm_90a``, ``-Xptxas -v``) through ``ops._build`` into
``icikit_torch/build/ab/``, named by a hash of the sources and the
flags, both builds at once; then, at (1, 8, 32768, d) bf16 for d = 64
and 128 (the tile-floor path's shapes), times each variant of source A,
B, B, A by CUDA events over back-to-back launches on the same tensors.
Beside each: the bound (4 * 128 * 128 * d operations a tile of the
rectangle at 989 TFLOP/s against q, k, v and out once at 3.35 TB/s: the
larger; 2.22 ms at d 64, 4.45 at d 128), the plain version's time, the
ns a 128 x 128 tile (``cuda_tile_floor.TILE``) of the rectangle, and
non-causal ``scaled_dot_product_attention``'s time at that d (the one
PyTorch call that computes softmax_ks1's function; none computes mxu's
or the ablations'). B's softmax_ks1 and that call are then timed in
``PAIRS`` alternating pairs (kernel first in the even pairs, the call
first in the odd), each side over ``ITERS`` launches, and the record
counts the pairs the kernel won.

Both arms are held to the plain version at the kernels' key tile, and
B to A, within ``TOL`` of the largest entry (``chip_smoke.py``'s
TILE_TOL): a departure marks the record ``"ok": false`` and exits 1,
unless ``--timing-only`` (a source whose kernels walk another key tile
departs on no_exp2, whose alpha acts per tile). Prints one JSON line a
(d, variant), the kernels' registers and spills and ptxas's notes on
wgmma as it reported them, and the card's name and power limit. Needs a
CUDA card.

    python -m icikit_torch.bench.tile_floor_ab --a OLD_DIR \\
        --b icikit_torch/csrc
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess

import torch

from icikit_torch.bench.tile_floor import ABLATIONS, LOG2E_JAX, tile_ops
from icikit_torch.ops import _build
from icikit_torch.ops import cuda_tile_floor as ctf

MEM_BPS = 3.35e12          # H100 SXM HBM3, NVIDIA's data sheet
BF16_TENSOR_OPS = 989e12   # dense bf16, the same
SHAPE = (1, 8, 32768)      # (b, h, s) of the tile-floor path
DIMS = (64, 128)
TOL = 2e-2                 # chip_smoke.py's TILE_TOL
ITERS = 10
PAIRS = 10                 # softmax_ks1 against SDPA, alternating
# (variant, use_exp2, use_max); None: tile_mxu
VARIANTS = (("mxu", None, None),) + ABLATIONS
FLAGS = {name: (e, m) for name, e, m in ABLATIONS}


def bound_ms(b: int, h: int, s: int, d: int) -> tuple:
    """(ms, "bytes" or "operations"): the least time the card could take
    for one variant over the rectangle at (b, h, s, d) bf16: 4 TILE^2 d
    operations a tile of the (s / TILE)^2 a head, against q, k, v read
    and out written once."""
    t = ctf.TILE
    ops = b * h * (s // t) ** 2 * tile_ops(t, t, d)
    t_o, t_b = ops / BF16_TENSOR_OPS, 4 * b * h * s * d * 2 / MEM_BPS
    return max(t_o, t_b) * 1e3, "operations" if t_o >= t_b else "bytes"


def build(arms: dict) -> dict:
    """{arm: (library, {kernel: (registers, spill bytes)}, ptxas's wgmma
    notes)} for ``arms`` = {arm: csrc directory}, built at once (one
    build a distinct source)."""
    from icikit_torch.bench.flash_ab import _ptxas_regs

    built = _build.build_sources(
        "tile_floor",
        {n: os.path.join(d, "tile_floor.cu") for n, d in arms.items()},
        os.path.join(_build.BUILD_DIR, "ab"), ("-Xptxas", "-v"))
    return {n: (lib, _ptxas_regs(log, lambda k: "tile_" in k),
                sorted({ln.strip() for ln in log.splitlines()
                        if "wgmma" in ln}))
            for n, (lib, log) in built.items()}


def kernel_call(lib, variant: str, q, k, v, out, scale_log2: float):
    """One library's ``variant`` into ``out``, a no-argument call."""
    b, h, s, d = q.shape
    st = torch.cuda.current_stream().cuda_stream
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b * h, s, d, scale_log2, st]
    if variant == "mxu":
        return lambda: _build.check(lib.icikit_tile_mxu(*args), "tile_mxu")
    e, m = FLAGS[variant]
    return lambda: _build.check(
        lib.icikit_tile_ablate(int(e), int(m), *args),
        f"tile_ablate {variant}")


def plain_call(variant: str, q, k, v, scale_log2: float):
    """The plain version of ``variant`` at the kernels' key tile, a
    no-argument call."""
    if variant == "mxu":
        return lambda: ctf.mxu_plain(q, k, v, scale_log2)
    return lambda: ctf.ablate_plain(q, k, v, scale_log2, *FLAGS[variant])


def pairs_ms(kernel, library, pairs: int = PAIRS,
             iters: int = ITERS) -> list:
    """[[kernel ms, library ms], ...]: ``pairs`` pairs, the kernel timed
    first in the even ones and the library call first in the odd."""
    from icikit_torch.bench.flash_ab import event_ms

    out = []
    for i in range(pairs):
        order = (kernel, library) if i % 2 == 0 else (library, kernel)
        t = [event_ms(fn, iters) for fn in order]
        out.append(t if i % 2 == 0 else t[::-1])
    return out


def run(arms: dict, shape=SHAPE, dims=DIMS, seed: int = 17) -> bool:
    """Time and compare the two arms; whether every record held."""
    import torch.nn.functional as F

    from icikit_torch.bench.flash_ab import _rel, _turns, event_ms

    libs = build(arms)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, h, s = shape
    tiles = b * h * (s // ctf.TILE) ** 2
    ok = True
    for d in dims:
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        scale_log2 = d ** -0.5 * LOG2E_JAX

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, scale=d ** -0.5)

        sdpa_ms = event_ms(sdpa, ITERS)
        bnd, by = bound_ms(b, h, s, d)
        for variant, _, _ in VARIANTS:
            outs = {n: torch.empty_like(q) for n in "AB"}
            fns = {n: {variant: kernel_call(libs[n][0], variant, q, k, v,
                                            outs[n], scale_log2)}
                   for n in "AB"}
            ms = _turns(fns, ITERS)
            plain = plain_call(variant, q, k, v, scale_log2)
            plain_ms = event_ms(plain, 1)
            want = plain()
            err = {"a_vs_plain": _rel(outs["A"], want),
                   "b_vs_plain": _rel(outs["B"], want),
                   "b_vs_a": _rel(outs["B"], outs["A"])}
            del want
            name = "tile_mxu" if variant == "mxu" else "tile_ablate"
            rec = {"kernel": f"{name} {variant} (B17)",
                   "shape": [b, h, s, d], "dtype": "bfloat16",
                   "turns": "A B B A", "tile": ctf.TILE,
                   "ms": {n: ms[n][variant] for n in "AB"},
                   "ns_a_tile": {n: [t / tiles * 1e6
                                     for t in ms[n][variant]] for n in "AB"},
                   "plain_ms": plain_ms,
                   "bound_ms": bnd, "bound_by": by,
                   "sdpa_noncausal_ms": sdpa_ms,
                   "library_ms": sdpa_ms if variant == "softmax_ks1"
                   else None,
                   "rel_err": err, "tolerance": TOL}
            if variant == "softmax_ks1":
                pairs = pairs_ms(fns["B"][variant], sdpa)
                rec["b_vs_sdpa_pairs_ms"] = pairs
                rec["b_won_pairs"] = sum(kt <= st for kt, st in pairs)
            rec["ok"] = all(e <= TOL for e in err.values())
            print(json.dumps(rec), flush=True)
            ok &= rec["ok"]
            del outs, fns
        del q, k, v
        torch.cuda.empty_cache()
    print(json.dumps({
        "registers_spill_bytes": {n: libs[n][1] for n in "AB"},
        "ptxas_wgmma_notes": {n: libs[n][2] for n in "AB"},
        "arms": arms}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip())
    return ok


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--a", required=True,
                   help="directory of arm A's tile_floor.cu")
    p.add_argument("--b", required=True, help="the same for arm B")
    p.add_argument("--timing-only", action="store_true",
                   help="exit 0 even where an arm's outputs depart")
    args = p.parse_args(argv)
    missing = [os.path.join(d, "tile_floor.cu") for d in (args.a, args.b)
               if not os.path.isfile(os.path.join(d, "tile_floor.cu"))]
    if missing:
        p.error(f"missing sources: {missing}")
    if not torch.cuda.is_available():
        raise SystemExit("tile_floor_ab needs a CUDA card")
    ok = run({"A": args.a, "B": args.b})
    return 0 if ok or args.timing_only else 1


if __name__ == "__main__":
    raise SystemExit(main())
