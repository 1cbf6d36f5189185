"""Attention kernel benchmark: dense vs flash, on one device.

The port of ``python -m icikit.bench.attention``: sweep sequence
lengths, verify every variant against an oracle, report fenced timings
(median-of-windows, ``utils.timing.timeit_windows``) and achieved
TFLOP/s. The subjects are the local kernels: ``dense`` (the oracle
formulation ``ops/attention.py``), ``flash`` and ``flash_shift`` (the
constant-shift forward). The backward of ``flash`` runs ``flash_bwd``
(B6/B7) while s * d * 4 bytes of dq fit the TPU's 48 MiB scratch budget
and the two-pass ``flash_bwd_dq``/``flash_bwd_dkv`` (B8) past it, as
JAX's ``_bwd_call`` routes. With ``--devices N`` (N > 1) the
sequence-parallel schedules join on a rank mesh of N
(``models/attention``: ``ring``, ``ulysses``, ``zigzag``), its ranks rows
of the one card, so their times are the schedules' own work on one
device, with no wire: each rank's blocks fold into the kernels' batch.

    python -m icikit_torch.bench.attention --seqs 32768,131072 \\
        --impls flash --batch 1 --heads 4 --dhead 128 --mode fwdbwd
    python -m icikit_torch.bench.attention --device cpu --seqs 64,128 \\
        --batch 1 --heads 2 --dhead 32 --runs 1 --warmup 1
    python -m icikit_torch.bench.attention --devices 8 \\
        --impls ring,zigzag,ulysses

The oracle: dense while b * h * s^2 <= 2^29 scores. Beyond that, JAX
checks the flash kernel against itself under another tiling; the port's
kernels take no tile sizes, so its oracle is the kernels' plain versions
(``flash_fwd_plain``, ``flash_bwd_plain``) computed chunk by chunk over Q
rows: exact, independent of the kernels, O(chunk * s) memory.

FLOPs accounting: forward = 4 b s^2 h d (two matmuls), halved when
causal; backward adds 2.5x forward (five matmuls including the
probability recompute). Approximate by design: softmax and mask ops are
left out. Records carry the JAX record's keys plus ``device``,
``power_limit`` and the kernel launches of the verification call.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from dataclasses import dataclass

import torch


@dataclass
class AttnRecord:
    impl: str
    mode: str             # "fwd" | "fwdbwd"
    batch: int
    seq: int
    heads: int
    d_head: int
    dtype: str
    causal: bool
    p: int                # devices (1 = local kernel)
    runs: int
    mean_s: float         # median under the windows protocol
    best_s: float
    tflops: float         # achieved, from the median
    max_err: float        # vs the oracle (dense within the memory
                          # budget, the chunked plain versions beyond it;
                          # fwd: outputs, fwdbwd: worst gradient)
    verified: bool
    protocol: str = "median-of-windows"
    min_s: float = 0.0
    max_s: float = 0.0
    windows: int = 1
    discarded: int = 0
    suspect: bool = False
    session_quality: dict | None = None
    device: str = "cpu"
    power_limit: str | None = None
    # kernel launches of one call (the verification call), by kernel
    launches: dict | None = None

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


def attention_flops(batch, seq, heads, d_head, causal, mode) -> float:
    fwd = 4.0 * batch * seq * seq * heads * d_head * (0.5 if causal else 1.0)
    return fwd * (3.5 if mode == "fwdbwd" else 1.0)


def _impl_fns(mesh=None):
    """name -> callable(q, k, v, causal) for the one-device subjects,
    and with a rank ``mesh`` of more than one rank the sequence-parallel
    schedules over it."""
    from icikit_torch.ops.attention import dense_attention
    from icikit_torch.ops.flash_attention import flash_attention

    fns = {
        "dense": lambda q, k, v, causal: dense_attention(q, k, v,
                                                         causal=causal),
        "flash": lambda q, k, v, causal: flash_attention(q, k, v,
                                                         causal=causal),
        "flash_shift": lambda q, k, v, causal: flash_attention(
            q, k, v, causal=causal, softmax_shift=16.0),
    }
    if mesh is not None and mesh.p > 1:
        from icikit_torch.models.attention import (ring_attention,
                                                   ulysses_attention,
                                                   zigzag_attention)
        fns["ring"] = lambda q, k, v, causal: ring_attention(
            q, k, v, mesh, causal=causal)
        fns["ulysses"] = lambda q, k, v, causal: ulysses_attention(
            q, k, v, mesh, causal=causal)
        fns["zigzag"] = lambda q, k, v, causal: zigzag_attention(
            q, k, v, mesh, causal=causal)
    return fns


# Above this many score-matrix elements the dense oracle's float32
# logits (2 GB at this bound) are replaced by the chunked plain versions.
_DENSE_ORACLE_MAX_SCORES = 1 << 29
# Q rows a step of the chunked oracle: a (1024, 131072) float32 block a
# head, 2 GB for 4 heads.
ORACLE_CHUNK = 1024


def _grads_of(fn, q, k, v):
    """Gradients of sum(fn(q, k, v).float()) in q, k and v."""
    ts = [t.detach().requires_grad_(True) for t in (q, k, v)]
    with torch.enable_grad():
        out = fn(*ts).float().sum()
        return torch.autograd.grad(out, ts)


def _chunked_plain(q, k, v, causal, mode):
    """The oracle beyond the dense budget: the flash kernels' plain
    versions, Q-row chunk by chunk, on (b, s, h, d) inputs. fwdbwd: the
    gradients of sum(out.float()), i.e. dO = 1 in out's dtype and no lse
    cotangent."""
    from icikit_torch.ops import cuda_attention as ca

    scale = q.shape[-1] ** -0.5
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    out, lse = ca.flash_fwd_plain(qt, kt, vt, causal, scale,
                                  chunk=ORACLE_CHUNK)
    if mode == "fwd":
        return out.transpose(1, 2)
    do = torch.ones_like(out)
    delta = (do.float() * out.float()).sum(dim=-1)
    del out
    grads = ca.flash_bwd_plain(qt, kt, vt, do, lse, delta, causal, scale,
                               chunk=ORACLE_CHUNK)
    return tuple(g.transpose(1, 2) for g in grads)


def _oracle(q, k, v, causal, mode):
    """Reference values: the dense oracle within the memory budget, the
    chunked plain versions beyond it."""
    from icikit_torch.ops.attention import dense_attention

    b, s, h, _ = q.shape
    if b * h * s * s > _DENSE_ORACLE_MAX_SCORES:
        return _chunked_plain(q, k, v, causal, mode)
    if mode == "fwd":
        with torch.no_grad():
            return dense_attention(q, k, v, causal=causal)
    return _grads_of(lambda q, k, v: dense_attention(q, k, v,
                                                     causal=causal), q, k, v)


def _rel_err(a, b) -> float:
    """Magnitude-normalized: bf16 subjects differ from the oracle by
    about one ulp at the value's own scale."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / max(1.0, float(b.abs().max())))


def _launches() -> dict:
    from icikit_torch.ops import cuda_attention as ca
    return dict(ca.LAUNCHES)


def sweep_attention(seqs, impls=None, batch=4, heads=8, d_head=64,
                    dtype="bfloat16", causal=True, mode="fwdbwd",
                    runs=10, warmup=2, devices=1, tol=3e-2,
                    device="cuda", windows=3):
    """Benchmark + verify each impl over a sequence-length sweep on
    ``device`` (the card unless the caller asks for the CPU)."""
    from icikit_torch.bench.headline import device_identity
    from icikit_torch.bench.train import detect_peak
    from icikit_torch.utils.timing import timeit_windows

    from icikit_torch.utils.mesh import make_mesh

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on "
                           "the CPU")
    p = devices or 1
    fns = _impl_fns(make_mesh(p, device=device) if p > 1 else None)
    impls = list(impls or fns)
    unknown = [n for n in impls if n not in fns]
    if unknown:
        raise ValueError(f"unknown impls {unknown} (known: "
                         f"{', '.join(fns)})")
    dt = getattr(torch, dtype)
    name, power = device_identity(device)
    # physical floor for corrupted-fast windows: nothing exceeds the
    # card's dense bf16 nameplate
    peak = detect_peak(device)
    records = []
    for seq in seqs:
        gen = torch.Generator(device=device).manual_seed(seq)
        q, k, v = (torch.randn((batch, seq, heads, d_head), generator=gen,
                               device=device).to(dt) for _ in range(3))
        want = _oracle(q, k, v, causal, mode)
        for impl in impls:
            fn = fns[impl]
            if mode == "fwd":
                def run(q, k, v, f=fn):
                    with torch.no_grad():
                        return f(q, k, v, causal)

                def first(out):
                    return out
            else:
                def run(q, k, v, f=fn):
                    return _grads_of(lambda q, k, v: f(q, k, v, causal),
                                     q, k, v)

                def first(out):
                    return out[0]
            before = _launches()
            got = run(q, k, v)
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
            launches = {k_: n - before[k_] for k_, n in _launches().items()
                        if n != before[k_]}
            if mode == "fwd":
                err = _rel_err(got, want)
            else:
                err = max(_rel_err(a, b) for a, b in zip(got, want))
            del got

            def chain(a, out, first=first):
                # the next q depends on this run's output: no run can be
                # elided (see timeit_windows)
                return (a[0] + 0.01 * first(out).to(a[0].dtype), a[1], a[2])

            fl = attention_flops(batch, seq, heads, d_head, causal, mode)
            floor_s = fl / peak if peak else None
            res = timeit_windows(run, (q, k, v), chain, windows=windows,
                                 runs=runs, warmup=warmup, floor_s=floor_s)
            records.append(AttnRecord(
                impl=impl, mode=mode, batch=batch, seq=seq, heads=heads,
                d_head=d_head, dtype=str(dt).replace("torch.", ""),
                causal=causal, p=p, runs=res.total_runs,
                mean_s=res.median_s, best_s=res.min_s,
                tflops=fl / res.median_s / 1e12, max_err=err,
                verified=err <= tol, min_s=res.min_s, max_s=res.max_s,
                windows=res.windows, discarded=res.discarded,
                suspect=res.suspect,
                session_quality=res.session_quality(), device=name,
                power_limit=power, launches=launches))
        del q, k, v, want
    return records


def format_table(records) -> str:
    if not records:
        return "(no records)"
    hdr = (f"{'impl':<12} {'mode':<7} {'seq':>6} {'p':>3} "
           f"{'median_ms':>9} {'spread_ms':>17} {'TFLOP/s':>9} "
           f"{'max_err':>9} {'ok':>3}")
    lines = [hdr, "-" * len(hdr)]
    for r in records:
        spread = (f"[{r.min_s * 1e3:.1f},{r.max_s * 1e3:.1f}]"
                  if r.windows > 1 else "-")
        lines.append(
            f"{r.impl:<12} {r.mode:<7} {r.seq:>6} {r.p:>3} "
            f"{r.mean_s * 1e3:>9.3f} {spread:>17} "
            f"{r.tflops:>9.2f} {r.max_err:>9.2e} "
            f"{'ok' if r.verified else 'NO':>3}"
            + ("  SUSPECT" if r.suspect else ""))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seqs", default="512,1024,2048,4096")
    ap.add_argument("--impls", default=None,
                    help="comma-separated (default: all)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--dhead", type=int, default=64)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--mode", default="fwdbwd", choices=["fwd", "fwdbwd"])
    ap.add_argument("--no-causal", dest="causal", action="store_false")
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--devices", type=int, default=None,
                    help="ranks of a rank mesh on the one device: "
                         "adds ring/ulysses/zigzag")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", dest="json_path", default=None)
    args = ap.parse_args(argv)
    records = sweep_attention(
        tuple(int(s) for s in args.seqs.split(",")),
        args.impls.split(",") if args.impls else None,
        batch=args.batch, heads=args.heads, d_head=args.dhead,
        dtype=args.dtype, causal=args.causal, mode=args.mode,
        runs=args.runs, warmup=args.warmup, devices=args.devices or 1,
        device=args.device)
    print(format_table(records))
    for r in records:
        print(r.to_json())
    if args.json_path:
        # append: records accumulate across invocations
        with open(args.json_path, "a") as f:
            for r in records:
                f.write(r.to_json() + "\n")
    if not all(r.verified for r in records):
        print("VERIFICATION FAILURES present", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
