"""Transformer training throughput: tokens/s and model-FLOPs utilization.

The port of ``python -m icikit.bench.train`` (its one-device rows).
FLOPs are counted as 6 x (matmul params) x tokens + attention's
12 x b x s^2 x H x Dh per layer, the PaLM-style accounting the JAX
bench uses. The step is ``make_train_step`` with ``FusedAdam``; steps
run in a Python loop with the parameters and the optimizer state
carried in place (the JAX bench chains them in a jitted ``fori_loop``),
timed by the median-of-windows protocol
(``utils.timing.timeit_windows``), windows below the nameplate's FLOP
floor discarded. Weights are random, from a ``torch.Generator`` seeded
with 0; tokens and targets from ``numpy.random.default_rng(0)``, as the
JAX bench makes them. Prints one JSON line with the JAX record's keys
plus ``device`` and ``power_limit``.

    python -m icikit_torch.bench.train --preset base --batch 8
    python -m icikit_torch.bench.train --device cpu --preset tiny \\
        --batch 2 --steps 2 --warmup 1 --windows 1

``--head recompute``, ``--head-bwd matmul`` and ``--optimizer
fused-pallas`` run the head's other flavours (B10 recompute, B11) and the
one-pass Adam kernel (B12); ``--save-stack pallas`` the layer stack
through the explicit save stack and its kernels (B16), JAX's A/B arm.
Flags the port has not reached (more than one device, MoE, optax, the
remat policies other than nothing and except_attn) raise.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

PRESETS = {
    "tiny": dict(vocab=256, d_model=128, n_heads=4, d_head=32, d_ff=512,
                 n_layers=2, max_seq=128),
    # tiny at the fused decode step's head width (d_head 128)
    "tiny128": dict(vocab=256, d_model=128, n_heads=2, d_head=128,
                    d_ff=512, n_layers=2, max_seq=128),
    "small": dict(vocab=32768, d_model=512, n_heads=4, d_head=128,
                  d_ff=2048, n_layers=8, max_seq=1024),
    "base": dict(vocab=32768, d_model=1024, n_heads=8, d_head=128,
                 d_ff=4096, n_layers=12, max_seq=1024),
}

# Dense bf16 peaks of the card, from NVIDIA's data sheets. The SXM part
# reports itself to CUDA as "NVIDIA H100 80GB HBM3", the PCIe part as
# "NVIDIA H100 PCIe".
PEAK_FLOPS = {
    "H100 SXM": 989e12,
    "H100 PCIe": 756e12,
    "cpu": 0.0,
}


def matmul_param_count(cfg) -> int:
    """Matmul parameters: per layer q, k, v, o and the two MLP
    matrices, plus the head and the embedding."""
    kv_heads = cfg.n_kv_heads or cfg.n_heads
    per_layer = (cfg.d_model * cfg.n_heads * cfg.d_head       # q proj
                 + 2 * cfg.d_model * kv_heads * cfg.d_head    # k, v proj
                 + cfg.n_heads * cfg.d_head * cfg.d_model     # wo
                 + 2 * cfg.d_model * cfg.d_ff)                # w1, w2
    return (cfg.n_layers * per_layer
            + cfg.d_model * cfg.vocab                         # head
            + cfg.vocab * cfg.d_model)                        # embedding


def step_flops(cfg, batch: int, seq: int) -> float:
    """6*P*T matmul FLOPs + attention score/value FLOPs (fwd+bwd)."""
    tokens = batch * seq
    mm = 6.0 * matmul_param_count(cfg) * tokens
    attn = 12.0 * batch * seq * seq * cfg.n_heads * cfg.d_head * cfg.n_layers
    return mm + attn


def peak_key(device_name: str | None) -> str | None:
    """The ``PEAK_FLOPS`` key of a card from its CUDA name, or None."""
    if device_name is None or "H100" not in device_name:
        return None
    if "PCIe" in device_name:
        return "H100 PCIe"
    if "HBM3" in device_name or "SXM" in device_name:
        return "H100 SXM"
    return None


def detect_peak(device: str = "cuda") -> float:
    """The nameplate dense bf16 FLOP/s of the card (0.0 on the CPU or
    for a card not in ``PEAK_FLOPS``)."""
    if torch.device(device).type != "cuda":
        return 0.0
    key = peak_key(torch.cuda.get_device_name(0))
    return PEAK_FLOPS[key] if key else 0.0


def measure_peak(n: int = 8192, iters: int = 50,
                 device: str = "cuda") -> float:
    """Achievable bf16 matmul FLOP/s on this card, measured: one chain
    of ``iters`` (n, n) products (``torch.matmul``, a yardstick only),
    scaled so the chain stays bounded, timed by the median-of-windows
    protocol."""
    from icikit_torch.utils.timing import timeit_windows

    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.randn((n, n), generator=gen, device=device).to(torch.bfloat16)
    b = (torch.randn((n, n), generator=gen, device=device)
         * n ** -0.5).to(torch.bfloat16)

    def chain(x):
        for _ in range(iters):
            x = x @ b
        return x

    res = timeit_windows(chain, (a,), lambda args, out: (out,), windows=3,
                         runs=1, warmup=1)
    return 2.0 * n ** 3 * iters / res.median_s


def _optimizer(name: str):
    from icikit_torch.models.transformer import FusedAdam
    if name == "optax":
        raise NotImplementedError(
            "--optimizer optax: optax transformations are not ported "
            "(ROADMAP A8); use a fused-* optimizer")
    if name == "fused-pallas":
        # the one-pass kernel (B12) with float32 moments, as JAX's bench
        return FusedAdam(1e-4, use_pallas=True)
    mom = {}
    if name == "fused-bf16nu":
        mom = dict(nu_dtype=torch.bfloat16)
    elif name == "fused-bf16mom":
        mom = dict(mu_dtype=torch.bfloat16, nu_dtype=torch.bfloat16)
    return FusedAdam(1e-4, **mom)


def run_bench(preset: str, dp: int, tp: int, sp: int, batch: int,
              steps: int, warmup: int, moe_experts: int = 0,
              kv_heads: int = 0, remat: bool = True,
              remat_policy: str = "nothing",
              calibrate_peak: bool = False,
              optimizer: str = "fused-bf16mom", windows: int = 3,
              softmax_shift: float | None = 16.0,
              head: str = "auto", head_bwd: str = "fused",
              save_stack: str = "xla", device: str = "cuda") -> dict:
    from icikit_torch.bench.headline import device_identity
    from icikit_torch.models.transformer import (TransformerConfig,
                                                 init_params,
                                                 make_model_mesh,
                                                 make_train_step)
    from icikit_torch.models.transformer.model import _use_fused_head
    from icikit_torch.utils.timing import fence, timeit_windows

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on "
                           "the CPU")
    if head == "auto":
        probe = TransformerConfig(**PRESETS[preset], n_experts=moe_experts,
                                  n_kv_heads=kv_heads)
        head = ("saved" if _use_fused_head(probe, batch // dp,
                                           probe.max_seq // sp)
                else "recompute")
    cfg = TransformerConfig(**PRESETS[preset], n_experts=moe_experts,
                            n_kv_heads=kv_heads, remat=remat,
                            remat_policy=remat_policy,
                            softmax_shift=softmax_shift,
                            xent_save_exp=(head == "saved"),
                            xent_fused_bwd=(head_bwd == "fused"),
                            save_stack=save_stack)
    if head == "saved" and not _use_fused_head(cfg, batch // dp,
                                               cfg.max_seq // sp):
        raise ValueError(
            "--head saved requires the fused xent head to be active, but "
            f"the gate rejects this config (preset={preset}, batch="
            f"{batch // dp}, seq={cfg.max_seq // sp}: needs tile-divisible "
            "T and V and d_model % 128 == 0)")
    mesh = make_model_mesh(dp=dp, tp=tp, sp=sp, device=device)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    opt, step = make_train_step(mesh, cfg, _optimizer(optimizer))
    opt_state = opt.init(params)

    rng = np.random.default_rng(0)
    seq = cfg.max_seq
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, seq))
                           .astype(np.int32)).to(device)
    tgt = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, seq))
                           .astype(np.int32)).to(device)

    loss = torch.zeros((), device=device)
    for _ in range(warmup):
        params, opt_state, loss = step(params, opt_state, tok, tgt)
    fence(loss)

    def multi(params, opt_state):
        out = (params, opt_state, loss)
        for _ in range(steps):
            out = step(out[0], out[1], tok, tgt)
        return out

    last = multi(params, opt_state)
    fence(last[2])
    loss_value = float(last[2])
    flops = step_flops(cfg, batch, seq)
    n_dev = dp * tp * sp
    nameplate = detect_peak(device) * n_dev
    floor_s = steps * flops / nameplate if nameplate else None
    wres = timeit_windows(multi, (params, opt_state),
                          lambda a, out: (out[0], out[1]),
                          windows=windows, runs=1, warmup=1,
                          floor_s=floor_s)
    dt = wres.median_s / steps
    tokens_s = batch * seq / dt
    peak = nameplate
    moe_tag = f"_e{moe_experts}" if moe_experts else ""
    kv_tag = f"_kv{kv_heads}" if kv_heads else ""
    remat_tag = "" if remat else "_noremat"
    if remat and remat_policy != "nothing":
        remat_tag = f"_rp-{remat_policy}"
    if optimizer != "fused-bf16mom":
        remat_tag += f"_opt-{optimizer}"
    if softmax_shift is None:
        remat_tag += "_noshift"
    elif softmax_shift != 16.0:
        remat_tag += f"_shift{softmax_shift:g}"
    if head != "saved":
        remat_tag += f"_head-{head}"
    if head_bwd != "fused":
        remat_tag += f"_hb-{head_bwd}"
    if save_stack != "xla":
        remat_tag += f"_stack-{save_stack}"
    name, power = device_identity(device)
    rec = {
        "metric":
            f"train_{preset}_dp{dp}tp{tp}sp{sp}_b{batch}{moe_tag}"
            f"{kv_tag}{remat_tag}",
        "value": round(tokens_s, 1),
        "unit": "tokens/s",
        "step_ms": round(dt * 1e3, 2),
        "model_tflops_per_s": round(flops / dt / 1e12, 2),
        "mfu": round(flops / dt / peak, 4) if peak else None,
        "loss": round(loss_value, 4),
        "protocol": "median-of-windows",
        "windows": wres.windows,
        "discarded": wres.discarded,
        "session_quality": wres.session_quality(),
        "step_ms_spread": [round(wres.min_s / steps * 1e3, 2),
                           round(wres.max_s / steps * 1e3, 2)],
        "optimizer": optimizer,
        "head": head,
        "head_bwd": head_bwd,
        "softmax_shift": softmax_shift,
        "save_stack": save_stack,
        "device": name,
        "power_limit": power,
    }
    if calibrate_peak:
        measured = measure_peak(device=device) * n_dev
        rec["measured_peak_tflops"] = round(measured / 1e12, 2)
        rec["mfu_vs_measured"] = round(flops / dt / measured, 4)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", default="small", choices=sorted(PRESETS))
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--sp", type=int, default=1)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--experts", type=int, default=0)
    ap.add_argument("--kv-heads", type=int, default=0)
    ap.add_argument("--remat-policy", default="except_attn",
                    choices=["nothing", "dots", "dots_attn", "dots_no_batch",
                             "except_attn"])
    ap.add_argument("--no-remat", dest="remat", action="store_false")
    ap.add_argument("--optimizer", default="fused-bf16mom",
                    choices=["fused", "fused-pallas", "fused-bf16nu",
                             "fused-bf16mom", "optax"])
    ap.add_argument("--softmax-shift", type=lambda s:
                    None if s.lower() in ("none", "off") else float(s),
                    default=16.0)
    ap.add_argument("--head", default="auto",
                    choices=["auto", "recompute", "saved"])
    ap.add_argument("--head-bwd", default="fused",
                    choices=["fused", "matmul"])
    ap.add_argument("--save-stack", default="xla", choices=["xla", "pallas"])
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--calibrate-peak", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rec = run_bench(args.preset, args.dp, args.tp, args.sp, args.batch,
                    args.steps, args.warmup, args.experts, args.kv_heads,
                    remat=args.remat, remat_policy=args.remat_policy,
                    calibrate_peak=args.calibrate_peak,
                    optimizer=args.optimizer, windows=args.windows,
                    softmax_shift=args.softmax_shift, head=args.head,
                    head_bwd=args.head_bwd, save_stack=args.save_stack,
                    device=args.device)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
