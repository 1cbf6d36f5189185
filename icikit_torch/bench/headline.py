"""Headline benchmark of the port — prints ONE JSON line.

Distributed bitonic sort of 2^28 int32 keys (the north-star size) with
p = 1 on one card, through ``icikit_torch.models.sort.sort``. Keys come
from a seeded ``torch.Generator`` on the device over the full int32
range; each timed run sorts the previous output scrambled by an odd
multiplier (``out * -1640531527`` in int32, a bijection), so every run
sorts new data. Timing is the median-of-windows protocol
(``utils.timing.timeit_windows``) with windows below the memory-bandwidth
floor discarded. The JSON has the keys of the JAX package's ``bench.py``
plus ``device`` and ``power_limit``.

    python -m icikit_torch.bench.headline              # on the card
    python -m icikit_torch.bench.headline --device cpu --log2n 14
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

MULT = -1640531527


def device_identity(device: str) -> tuple[str, str | None]:
    """(name, power limit) of the card, or ("cpu", None)."""
    if torch.device(device).type != "cuda":
        return "cpu", None
    name = torch.cuda.get_device_name(0)
    try:
        q = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        power = q.stdout.strip().splitlines()[0] if q.returncode == 0 \
            else None
    except (OSError, subprocess.TimeoutExpired, IndexError):
        power = None
    return name, power


def make_keys(n: int, device: str, seed: int = 0) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(-2**31, 2**31 - 1, (n,), generator=gen,
                         dtype=torch.int32, device=device)


def run(log2n: int = 28, device: str = "cuda") -> dict:
    """The headline record: sort throughput of 2^log2n keys with p = 1
    on ``device``, timed as ``bench.py`` times it (3 windows, 4 runs a
    window to start)."""
    from icikit_torch.bench.sort import sort_floor_s
    from icikit_torch.models.sort import sort as dist_sort
    from icikit_torch.utils.mesh import make_mesh
    from icikit_torch.utils.timing import timeit_windows

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on "
                           "the CPU")
    p = 1
    mesh = make_mesh(p, device=device)
    n = 1 << log2n
    keys = make_keys(n, device)

    def fn(x):
        return dist_sort(x, mesh, algorithm="bitonic")

    def chain(args, out):
        return (out * MULT,)

    floor = (sort_floor_s(n, p, 4)
             if torch.device(device).type == "cuda" else None)
    res = timeit_windows(fn, (keys,), chain, windows=3, runs=4,
                         warmup=1, floor_s=floor)
    keys_per_s = n / res.median_s
    name, power = device_identity(device)
    return {
        "metric": f"bitonic_sort_throughput_p{p}_n2e{log2n}_int32",
        "value": round(keys_per_s, 1),
        "unit": "keys/s",
        "vs_baseline": round(keys_per_s / float(1 << 28), 4),
        "seconds_per_sort": round(res.median_s, 6),
        "spread_s": [round(res.min_s, 6), round(res.max_s, 6)],
        "windows": res.windows,
        "discarded": res.discarded,
        "suspect": res.suspect,
        "session_quality": res.session_quality(),
        "protocol": "median-of-windows",
        "device": name,
        "power_limit": power,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--log2n", type=int, default=28)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.log2n, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
