"""Decode throughput: tokens/s of greedy generation with a KV cache.

The port of ``python -m icikit.bench.decode`` for its
non-speculative rows: greedy or sampled (``--sampling sample``: JAX's
draw, key data of seed 1, temperature 0.8, top_k 40), at any (dp, tp)
mesh of the card (``--dp``, ``--tp``), MHA or GQA (``--kv-heads``),
bf16 or int8 (``--decode-quant int8``: weights quantized once, outside
the timing, and int8 KV caches; the metric carries ``_q8``). The metric
names the mesh and the sampling as JAX's does. Prefill a prompt, generate
``n_new`` tokens, report tokens/s and per-token milliseconds by the
chained median-of-windows protocol (each run's prompt is the previous
run's generated tail, with one counter token so no two runs see the
same prompt), and the read bandwidth the byte model implies. Weights
are random, from a ``torch.Generator`` seeded with 0. Prints one JSON line
with the JAX record's keys plus ``device`` and ``power_limit``.

    python -m icikit_torch.bench.decode --preset base --batch 8 \\
        --prompt 512 --new 64 --decode-step fused
    python -m icikit_torch.bench.decode --preset base --batch 8 \\
        --prompt 512 --new 64 --decode-step fused --decode-quant int8
    python -m icikit_torch.bench.decode --preset base --batch 8 \\
        --prompt 512 --new 64 --decode-step fused --dp 2 --tp 2 \\
        --sampling sample
    python -m icikit_torch.bench.decode --device cpu --preset tiny \\
        --batch 2 --prompt 8 --new 4
"""

from __future__ import annotations

import argparse
import json
import sys

import torch


BYTES_DTYPES = ("bf16", "int8")


def quant_scale_count(cfg) -> int:
    """float32 per-output-channel scales the int8 decode dict adds
    (``models/transformer/quant`` layouts), as JAX counts them."""
    L, D, H, Dh, F = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                      cfg.d_head, cfg.d_ff)
    kv = cfg.n_kv_heads or cfg.n_heads
    if kv != cfg.n_heads:
        attn = L * H * Dh + L * 2 * kv * Dh      # wq + wkv
    else:
        attn = L * 3 * H * Dh                     # wqkv
    return attn + L * D + L * F + L * D + cfg.vocab  # wo, w1, w2, w_out


def decode_bytes_per_token(cfg, batch: int, cache_len: float,
                           vmem_resident: int = 0,
                           bytes_dtype: str = "bf16") -> float:
    """Device-memory bytes one decode step must read: every matmul
    weight once (the embedding is a b-row gather, not a full read, so
    it is left out) plus the KV cache of ``cache_len`` columns, at two
    bytes an element (``bytes_dtype="bf16"``) or one (``"int8"``, which
    adds the float32 scales: one per weight output channel, one per
    cache column and K/V head). ``vmem_resident`` is the JAX model's
    share of the weights a TPU keeps in VMEM across steps; the H100 has
    no such store (50 MB of L2 is not reserved for weights), so it is
    0."""
    from icikit_torch.bench.train import matmul_param_count
    if bytes_dtype not in BYTES_DTYPES:
        raise ValueError(f"unknown bytes_dtype {bytes_dtype!r} "
                         f"(known: {', '.join(BYTES_DTYPES)})")
    wb = 1.0 if bytes_dtype == "int8" else 2.0
    kv_heads = cfg.n_kv_heads or cfg.n_heads
    params = matmul_param_count(cfg) - cfg.vocab * cfg.d_model
    cache = 2 * batch * cache_len * kv_heads * cfg.d_head * cfg.n_layers
    param_bytes, cache_bytes = wb * params, wb * cache
    if bytes_dtype == "int8":
        param_bytes += 4.0 * quant_scale_count(cfg)
        cache_bytes += 4.0 * 2 * batch * cache_len * kv_heads \
            * cfg.n_layers
    return max(0.0, param_bytes - vmem_resident) + cache_bytes


def make_config(preset: str, prompt_len: int, n_new: int, **over):
    """The preset's ``TransformerConfig`` with max_seq raised to hold
    the prompt and the new tokens."""
    from icikit_torch.bench.train import PRESETS
    from icikit_torch.models.transformer import TransformerConfig
    base = dict(PRESETS[preset])
    base["max_seq"] = max(base["max_seq"], prompt_len + n_new)
    return TransformerConfig(**base, **over)


# JAX's sampled arm (``icikit/bench/decode.py``): key 1, temperature
# 0.8, top_k 40
SAMPLE_SEED, SAMPLE_KNOBS = 1, dict(temperature=0.8, top_k=40)


def run_bench(preset: str, batch: int, prompt_len: int, n_new: int,
              runs: int = 3, windows: int = 3,
              decode_step: str = "unfused", device: str = "cuda",
              decode_quant: str = "none", dp: int = 1, tp: int = 1,
              sampling: str = "greedy", kv_heads: int = 0) -> dict:
    from icikit_torch.bench.headline import device_identity
    from icikit_torch.bench.sort import hbm_nameplate_bytes
    from icikit_torch.models.transformer import (
        greedy_generate, init_params, make_model_mesh, sample_generate)
    from icikit_torch.models.transformer.decode import (
        _resolve_decode_step, maybe_quantize_params)
    from icikit_torch.utils.threefry import key_data
    from icikit_torch.utils.timing import timeit_windows

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on "
                           "the CPU")
    if n_new < 2:
        raise ValueError("n_new must be >= 2")
    if sampling not in ("greedy", "sample"):
        raise ValueError(f"unknown sampling {sampling!r} "
                         "(known: greedy, sample)")
    cfg = make_config(preset, prompt_len, n_new, decode_step=decode_step,
                      decode_quant=decode_quant, n_kv_heads=kv_heads)
    bytes_dtype = "int8" if decode_quant == "int8" else "bf16"
    mesh = make_model_mesh(dp=dp, tp=tp, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    # int8: quantized once, outside the timing loop, so the rows price
    # the int8 stream and not the one-time conversion
    params = maybe_quantize_params(init_params(cfg, gen, device), mesh, cfg)
    p0 = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen,
                       device=device, dtype=torch.int32)

    key = key_data(SAMPLE_SEED)

    def run(prompt):
        if sampling == "greedy":
            return greedy_generate(params, prompt, mesh, cfg, n_new)
        return sample_generate(params, prompt, mesh, cfg, n_new, key,
                               **SAMPLE_KNOBS)

    ctr = [0]

    def chain(args, out):
        ctr[0] += 1
        nxt = out[:, -prompt_len:].clone()
        nxt[0, 0] = ctr[0] % cfg.vocab
        return (nxt,)

    cache_len = prompt_len + n_new
    per_token_bytes = decode_bytes_per_token(cfg, batch, cache_len,
                                             bytes_dtype=bytes_dtype)
    bw = hbm_nameplate_bytes() if torch.device(device).type == "cuda" \
        else None
    floor_s = n_new * per_token_bytes / bw if bw else None
    res = timeit_windows(run, (p0,), chain, windows=windows, runs=runs,
                         warmup=1, floor_s=floor_s)
    per_token_s = res.median_s / n_new
    step_tag = "" if decode_step == "unfused" else f"_{decode_step}"
    kv_tag = f"_kv{kv_heads}" if kv_heads else ""
    if decode_quant == "int8":
        kv_tag += "_q8"
    name, power = device_identity(device)
    return {
        "metric": f"decode_{preset}_dp{dp}tp{tp}_b{batch}{kv_tag}"
                  f"_p{prompt_len}_n{n_new}_{sampling}{step_tag}",
        "decode_step": decode_step,
        "decode_step_resolved": ("fused" if _resolve_decode_step(cfg, device)
                                 else "unfused"),
        "decode_quant": decode_quant,
        "bytes_dtype": bytes_dtype,
        "backend": torch.device(device).type,
        "value": round(batch / per_token_s, 1),
        "unit": "tokens/s",
        "per_token_ms": round(per_token_s * 1e3, 3),
        "read_gbps": round(per_token_bytes / per_token_s / 1e9, 1),
        "batch": batch,
        "includes_prefill": True,
        "bytes_model": f"{bytes_dtype}-weights-and-cache-no-resident",
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
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=64)
    ap.add_argument("--new", dest="n_new", type=int, default=64)
    ap.add_argument("--sampling", default="greedy",
                    choices=["greedy", "sample"])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--kv-heads", type=int, default=0)
    ap.add_argument("--decode-step", default="unfused",
                    choices=["auto", "fused", "unfused"])
    ap.add_argument("--decode-quant", default="none",
                    choices=["none", "int8"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(run_bench(args.preset, args.batch, args.prompt,
                               args.n_new, args.runs,
                               decode_step=args.decode_step,
                               device=args.device,
                               decode_quant=args.decode_quant,
                               dp=args.dp, tp=args.tp,
                               sampling=args.sampling,
                               kv_heads=args.kv_heads)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
