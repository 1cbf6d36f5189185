"""Decode throughput: tokens/s of greedy generation with a KV cache.

The port of ``python -m icikit.bench.decode`` for its greedy,
non-speculative, non-quantized rows. Prefill a prompt, generate
``n_new`` tokens, report tokens/s and per-token milliseconds by the
chained median-of-windows protocol (each run's prompt is the previous
run's generated tail, with one counter token so no two runs see the
same prompt), and the read bandwidth the byte model implies. Weights
are random, from a ``torch.Generator`` seeded with 0. Prints one JSON line
with the JAX record's keys plus ``device`` and ``power_limit``.

    python -m icikit_torch.bench.decode --preset base --batch 8 \\
        --prompt 512 --new 64 --decode-step fused
    python -m icikit_torch.bench.decode --device cpu --preset tiny \\
        --batch 2 --prompt 8 --new 4
"""

from __future__ import annotations

import argparse
import json
import sys

import torch


def decode_bytes_per_token(cfg, batch: int, cache_len: float,
                           vmem_resident: int = 0) -> float:
    """Device-memory bytes one decode step must read: every matmul
    weight once as a bf16 copy (the embedding is a b-row gather, not a
    full read, so it is left out) plus the bf16 KV cache of
    ``cache_len`` columns. ``vmem_resident`` is the JAX model's share of
    the weights a TPU keeps in VMEM across steps; the H100 has no such
    store (50 MB of L2 is not reserved for weights), so it is 0."""
    from icikit_torch.bench.train import matmul_param_count
    kv_heads = cfg.n_kv_heads or cfg.n_heads
    params = matmul_param_count(cfg) - cfg.vocab * cfg.d_model
    cache = 2 * batch * cache_len * kv_heads * cfg.d_head * cfg.n_layers
    return max(0.0, 2.0 * params - vmem_resident) + 2.0 * cache


def make_config(preset: str, prompt_len: int, n_new: int, **over):
    """The preset's ``TransformerConfig`` with max_seq raised to hold
    the prompt and the new tokens."""
    from icikit_torch.bench.train import PRESETS
    from icikit_torch.models.transformer import TransformerConfig
    base = dict(PRESETS[preset])
    base["max_seq"] = max(base["max_seq"], prompt_len + n_new)
    return TransformerConfig(**base, **over)


def run_bench(preset: str, batch: int, prompt_len: int, n_new: int,
              runs: int = 3, windows: int = 3,
              decode_step: str = "unfused", device: str = "cuda") -> dict:
    from icikit_torch.bench.headline import device_identity
    from icikit_torch.bench.sort import hbm_nameplate_bytes
    from icikit_torch.models.transformer import (
        greedy_generate, init_params, make_model_mesh)
    from icikit_torch.models.transformer.decode import _resolve_decode_step
    from icikit_torch.utils.timing import timeit_windows

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on "
                           "the CPU")
    if n_new < 2:
        raise ValueError("n_new must be >= 2")
    cfg = make_config(preset, prompt_len, n_new, decode_step=decode_step)
    mesh = make_model_mesh(device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen, device)
    p0 = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen,
                       device=device, dtype=torch.int32)

    def run(prompt):
        return greedy_generate(params, prompt, mesh, cfg, n_new)

    ctr = [0]

    def chain(args, out):
        ctr[0] += 1
        nxt = out[:, -prompt_len:].clone()
        nxt[0, 0] = ctr[0] % cfg.vocab
        return (nxt,)

    cache_len = prompt_len + n_new
    per_token_bytes = decode_bytes_per_token(cfg, batch, cache_len)
    bw = hbm_nameplate_bytes() if torch.device(device).type == "cuda" \
        else None
    floor_s = n_new * per_token_bytes / bw if bw else None
    res = timeit_windows(run, (p0,), chain, windows=windows, runs=runs,
                         warmup=1, floor_s=floor_s)
    per_token_s = res.median_s / n_new
    step_tag = "" if decode_step == "unfused" else f"_{decode_step}"
    name, power = device_identity(device)
    return {
        "metric": f"decode_{preset}_dp1tp1_b{batch}_p{prompt_len}"
                  f"_n{n_new}_greedy{step_tag}",
        "decode_step": decode_step,
        "decode_step_resolved": ("fused" if _resolve_decode_step(cfg, device)
                                 else "unfused"),
        "decode_quant": "none",
        "bytes_dtype": "bf16",
        "backend": torch.device(device).type,
        "value": round(batch / per_token_s, 1),
        "unit": "tokens/s",
        "per_token_ms": round(per_token_s * 1e3, 3),
        "read_gbps": round(per_token_bytes / per_token_s / 1e9, 1),
        "batch": batch,
        "includes_prefill": True,
        "bytes_model": "bf16-weights-and-cache-no-resident",
        "vmem_resident_bytes": 0,
        "bound_ms_per_token": (per_token_bytes / bw * 1e3) if bw else None,
        "protocol": "median-of-windows",
        "windows": res.windows,
        "discarded": res.discarded,
        "suspect": res.suspect,
        "session_quality": res.session_quality(),
        "per_token_ms_spread": [round(res.min_s / n_new * 1e3, 3),
                                round(res.max_s / n_new * 1e3, 3)],
        "device": name,
        "power_limit": power,
    }


def main(argv=None) -> int:
    from icikit_torch.bench.train import PRESETS

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", default="small", choices=sorted(PRESETS))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=64)
    ap.add_argument("--new", dest="n_new", type=int, default=64)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--decode-step", default="unfused",
                    choices=["auto", "fused", "unfused"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(run_bench(args.preset, args.batch, args.prompt,
                               args.n_new, args.runs,
                               decode_step=args.decode_step,
                               device=args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
