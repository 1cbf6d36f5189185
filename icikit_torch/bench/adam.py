"""Standalone optimizer-tail bench: one-pass Adam against its memory floor.

The port of ``python -m icikit.bench.adam``. The optimizer tail is pure
memory streaming: with bf16 gradients, 26 B an element (read p, m, v
float32 and g bf16, write p, m, v). One ``(rows, 128)`` leaf of
``--params-m`` million parameters (the base preset's 211 M by default),
float32 moments, updated in place and timed by the median-of-windows
protocol (``utils.timing.timeit_windows``), in two arms:

- ``pallas``: the one-pass CUDA kernel (``ops.cuda_adam``, the
  counterpart of the TPU kernel B12), ``adam_apply(use_pallas=True)``;
- ``xla``: the PyTorch formulation the default train step runs
  (``ops/cuda_adam.adam_leaf_plain``, the kernel's plain version).

GB/s come from the 26 B an element, beside the card's measured copy rate
(the session canary, ``utils.timing.session_canary``) and its nameplate.
A third record times ``torch._fused_adam_`` on the same leaf with float32
gradients (28 B an element) as a yardstick only: optax's Adam with
eps_root = 0 is torch's Adam without weight decay, the same update up to
rounding (sqrt(v / (1 - b2^t)) against sqrt(v) / sqrt(1 - b2^t)). The
port never calls it. One JSON line a record, with ``device`` and
``power_limit``.

    python -m icikit_torch.bench.adam --params-m 211 --runs 4
    python -m icikit_torch.bench.adam --device cpu --params-m 0.1 --runs 1
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

LANES = 128


def _leaf(rows: int, grad_dtype, device: str, seed: int = 0):
    gen = torch.Generator(device=device).manual_seed(seed)
    p = torch.randn((rows, LANES), generator=gen, device=device)
    m = torch.zeros_like(p)
    v = torch.zeros_like(p)
    g = torch.randn((rows, LANES), generator=gen,
                    device=device).to(grad_dtype)
    return p, m, v, g


def run_bench(params_m: float = 211.0, runs: int = 4,
              grad_dtype: str = "bfloat16", device: str = "cuda",
              windows: int = 3) -> list[dict]:
    from icikit_torch.bench.headline import device_identity
    from icikit_torch.bench.sort import hbm_nameplate_bytes
    from icikit_torch.ops.adam import adam_apply
    from icikit_torch.utils.timing import session_canary, timeit_windows

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on "
                           "the CPU")
    n = int(params_m * 1e6)
    rows = n // LANES
    n = rows * LANES
    gdt = getattr(torch, grad_dtype)
    gsize = torch.empty((), dtype=gdt).element_size()
    bytes_per = 3 * 4 + 3 * 4 + gsize   # r p/m/v + w p/m/v + r g
    name, power = device_identity(device)
    on_card = torch.device(device).type == "cuda"
    canary = session_canary() if on_card else None
    nameplate = hbm_nameplate_bytes(name) if on_card else None

    def record(arm, res, per_elem, extra):
        gbps = n * per_elem / res.median_s / 1e9
        rec = {"metric": f"adam_onepass_{arm}_{params_m:g}M_"
                         f"{grad_dtype if arm != 'library' else 'float32'}",
               "value": round(gbps, 1), "unit": "GB/s",
               "ms": res.median_s * 1e3,
               "ms_spread": [res.min_s * 1e3, res.max_s * 1e3],
               "windows": res.windows, "bytes_per_element": per_elem,
               "elements": n,
               "bound_ms": n * per_elem / nameplate * 1e3
               if nameplate else None,
               "copy_gbps": canary["canary_gbs"] if canary else None,
               "pct_copy": round(100 * gbps / canary["canary_gbs"], 1)
               if canary else None,
               "nameplate_gbps": nameplate / 1e9 if nameplate else None,
               "pct_nameplate": round(100 * gbps / (nameplate / 1e9), 1)
               if nameplate else None,
               "device": name, "power_limit": power}
        rec.update(extra)
        return rec

    records = []
    for arm in ("pallas", "xla"):
        p, m, v, g = _leaf(rows, gdt, device)

        def step(p, m, v, t, arm=arm):
            adam_apply({"w": p}, {"w": m}, {"w": v}, {"w": g}, 1e-3, t,
                       use_pallas=arm == "pallas")
            return p, m, v, t + 1

        res = timeit_windows(step, (p, m, v, torch.ones((), dtype=torch.int32,
                                                        device=device)),
                             lambda a, out: out, windows=windows, runs=runs,
                             warmup=1)
        records.append(record(arm, res, bytes_per, {}))
        del p, m, v, g

    # the library's fused Adam on the same leaf, float32 gradients
    p, m, v, g = _leaf(rows, torch.float32, device)
    steps = torch.zeros((), dtype=torch.float32, device=device)

    def lib_step(p, m, v, s):
        s += 1
        torch._fused_adam_([p], [g], [m], [v], [], [s], amsgrad=False,
                           lr=1e-3, beta1=0.9, beta2=0.999,
                           weight_decay=0.0, eps=1e-8, maximize=False)
        return p, m, v, s

    res = timeit_windows(lib_step, (p, m, v, steps), lambda a, out: out,
                         windows=windows, runs=runs, warmup=1)
    records.append(record("library", res, 3 * 4 + 3 * 4 + 4, {
        "yardstick": "torch._fused_adam_ (torch.optim.Adam's fused "
                     "kernel), float32 gradients; the same update as "
                     "optax.adam with eps_root=0 up to rounding"}))
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--params-m", type=float, default=211.0,
                    help="leaf size in millions of parameters (default: "
                         "the base preset's 211M)")
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--grad-dtype", default="bfloat16")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", dest="json_path", default=None)
    args = ap.parse_args(argv)
    recs = run_bench(args.params_m, args.runs, args.grad_dtype, args.device)
    for rec in recs:
        print(json.dumps(rec))
    if args.json_path:
        with open(args.json_path, "a") as f:
            for rec in recs:
                f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
