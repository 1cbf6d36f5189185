"""The recompute head's backward (B10 recompute, ``xent_recompute_bf16``
dx and dw) of two source directories, timed in turns on one card.

Builds ``xent.cu`` of each directory (with the headers beside it) with
``nvcc`` (for ``sm_90a``, ``-Xptxas -v``) through
``ops._build.build_sources`` into ``icikit_torch/build/ab/``, named by a
hash of the sources and the flags, then times the recompute dx and dw of
source A, B, B, A by CUDA events over back-to-back launches on the same
tensors, at the ``base`` train step's head: T 8192, D 1024, V 32768,
bf16, lse from the plain forward. Beside each: the bound (the rebuild and
the contraction, 2 x 2 T V D operations at 989 TFLOP/s, against x, w
and the output once at 3.35 TB/s: the larger), the plain version's time,
and cuBLAS's ``x @ w.T`` alone (no one PyTorch call forms dx or dw from
recomputed logits; the head rows of ``PERF.md`` carry this yardstick).

B's dx and dw are held to A's and to the plain versions within
``chip_smoke.py``'s bf16 head tolerance (phase 13's XENT_TOL: 2e-2 of
the largest entry; g is rounded to bf16 for the tensor cores, the plain
version contracts it in float32): a departure marks the record ``"ok":
false`` and exits 1, unless ``--timing-only``. Prints one JSON line a
kernel, the kernels' registers and spills as ptxas reported them, and
the card's name and power limit. Needs a CUDA card.

    python -m icikit_torch.bench.xent_ab --a OLD_DIR --b icikit_torch/csrc

With ``--flavour saved`` it times the saved flavour's dx and dw instead
(B10 saved, ``xent_dx_bf16``/``xent_dw_bf16``: g rebuilt from the saved
exponentials e and mrun, here from the plain forward) at the same shape,
A, B, B, A, held to the saved plain versions and B to A within TOL,
beside the saved bound (2 T V D operations at 989 TFLOP/s against e,
mrun, w or x, the token vectors and the output once at 3.35 TB/s: the
larger, 0.556 ms) and, as the nearest yardstick (not the same
function), cuBLAS's product of the same shape on a materialized bf16 g:
``g @ w`` for dx, ``g.T @ x`` for dw.

With ``--flavour wide`` it times the recompute flavour past one
cluster's D 2048 at ``WIDE_SHAPE`` (T 8192, D 4096, V 32768, bf16):
dx and dw of A, B, B, A, each beside its bound (as above), its plain
version and its logits and product kernels' device time in one traced
call of B. A source with the chunk walk's entries (``icikit_xent_g_cols``,
``icikit_xent_g_product``) runs ``cuda_xent.recompute_walk`` over its
own library; an older one (the 128 x 128 tiled kernel) its
``icikit_xent_recompute``. B is held to A and to the plain versions
within TOL, and A and B to the plain versions also at lse less log V,
where g's softmax part outweighs the -dnll at a row's target. The same
run times B's walk at the base shape (D 1024) beside B's cluster
kernel, the route D <= 2048 takes, in turns cluster, walk, walk,
cluster, both held to the plain versions.

With ``--flavour fwd`` it times the head's forward (B9, ``xent_fwd_bf16``)
with ``save`` on and off, and with ``--flavour g`` the matmul backward's
recomputed g (B11, ``xent_g_bf16``, lse from the plain forward), each A,
B, B, A at the same shape through the C entries ``icikit_xent_fwd`` and
``icikit_xent_g``. B is held to A and to the plain versions: lse and the
target logit within ``LSE_TOL`` (1e-3, phase 12's XENT_TOL), e, mrun and
g within ``TOL`` of the largest entry; a second call of B must give the
same bits. Beside each: the bound (2 T V D operations at 989 TFLOP/s
against x, w, the token vectors and the outputs, e and mrun with save,
once at 3.35 TB/s: the larger, 0.556 ms) and, as the nearest yardstick
(not the same function), cuBLAS's ``x @ w.T`` with a bf16 output: the
same product, writing the (T, V) bytes that g and e take.

    python -m icikit_torch.bench.xent_ab --a OLD --b icikit_torch/csrc --flavour g
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess

import torch

from icikit_torch.ops import _build

MEM_BPS = 3.35e12          # H100 SXM HBM3, NVIDIA's data sheet
BF16_TENSOR_OPS = 989e12   # dense bf16, the same
SHAPE = (8192, 1024, 32768)   # (T, D, V) of the base step's head
KERNELS = ("dx", "dw")
TOL = 2e-2                 # chip_smoke.py's XENT_TOL["bf16"]["grad"]
LSE_TOL = 1e-3             # chip_smoke.py's XENT_TOL["bf16"]["lse"]
ITERS = 5
FLAVOURS = ("recompute", "saved", "fwd", "g", "wide")
WIDE_SHAPE = (8192, 4096, 32768)   # (T, D, V) past one cluster's D 2048
WIDE_ITERS = 3
CHUNK = 128                # mrun's chunk in bf16 (cuda_xent.TILE)


def bound_ms(which: str, t: int, d: int, v: int) -> tuple:
    """(ms, "bytes" or "operations"): the least time the card could take
    for the recompute ``which`` at (T, D, V) in bf16: x and w read, the
    output ((T, D) or (V, D)) written, targets, lse and dnll read once,
    against the logits' rebuild and the contraction, 2 x 2 T V D."""
    out_rows = t if which == "dx" else v
    nbytes = (t * d + v * d + out_rows * d) * 2 + 3 * t * 4
    ops = 2 * 2 * t * v * d
    t_b, t_o = nbytes / MEM_BPS, ops / BF16_TENSOR_OPS
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def saved_bound_ms(which: str, t: int, d: int, v: int) -> tuple:
    """(ms, "bytes" or "operations"): the least time for the saved
    ``which`` at (T, D, V) in bf16: e (T, V) and mrun (V / 128, T) read,
    w (dx) or x (dw) read, targets, lse and dnll read, the output written
    once, against the contraction's 2 T V D operations."""
    out_rows = t if which == "dx" else v
    other_rows = v if which == "dx" else t
    nbytes = (t * v + other_rows * d + out_rows * d) * 2 \
        + -(-v // CHUNK) * t * 4 + 3 * t * 4
    t_b, t_o = nbytes / MEM_BPS, 2 * t * v * d / BF16_TENSOR_OPS
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def fwd_bound_ms(save: bool, t: int, d: int, v: int) -> tuple:
    """(ms, "bytes" or "operations"): the least time for the forward at
    (T, D, V) in bf16: x and w read, the targets read, lse and the target
    logit written, with ``save`` also e (T, V) and mrun (V / 128, T)
    written, against the logits' 2 T V D operations."""
    nbytes = (t * d + v * d) * 2 + 3 * t * 4
    if save:
        nbytes += t * v * 2 + -(-v // CHUNK) * t * 4
    t_b, t_o = nbytes / MEM_BPS, 2 * t * v * d / BF16_TENSOR_OPS
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def g_bound_ms(t: int, d: int, v: int) -> tuple:
    """(ms, "bytes" or "operations"): the least time for the recomputed
    g at (T, D, V) in bf16: x and w read, targets, lse and dnll read, g
    (T, V) written, against the logits' 2 T V D operations."""
    nbytes = (t * d + v * d + t * v) * 2 + 3 * t * 4
    t_b, t_o = nbytes / MEM_BPS, 2 * t * v * d / BF16_TENSOR_OPS
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def build(a_dir: str, b_dir: str, kernels=("xent_recompute_bf16",)) -> dict:
    """{"A"/"B": (library, {kernel: (registers, spill bytes)})}, the two
    sources compiled in parallel; ptxas's numbers of the kernels whose
    name holds one of ``kernels``."""
    from icikit_torch.bench.flash_ab import _ptxas_regs

    built = _build.build_sources(
        "xent", {n: os.path.join(d, "xent.cu")
                 for n, d in (("A", a_dir), ("B", b_dir))},
        os.path.join(_build.BUILD_DIR, "ab"), ("-Xptxas", "-v"))
    return {n: (lib, _ptxas_regs(log, lambda k: any(s in k
                                                   for s in kernels)))
            for n, (lib, log) in built.items()}


def report(libs, a_dir: str, b_dir: str) -> None:
    """The run's last lines: ptxas's registers and spills of both
    sources, and the card's name and power limit."""
    print(json.dumps({"registers_spill_bytes": {n: libs[n][1] for n in "AB"},
                      "sources": {"A": a_dir, "B": b_dir}}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip())


def recompute_call(lib, which: str, x, w, tg, lse, dn, out):
    """One library's recompute ``which`` into ``out``, a no-argument
    call."""
    t, d = x.shape
    v = w.shape[0]
    st = torch.cuda.current_stream().cuda_stream
    args = [1, int(which == "dx"), x.data_ptr(), w.data_ptr(),
            tg.data_ptr(), lse.data_ptr(), dn.data_ptr(), out.data_ptr(),
            t, v, d, st]
    return lambda: _build.check(lib.icikit_xent_recompute(*args),
                                f"xent_{which}")


def walk_call(lib, which: str, x, w, tg, lse, dn, out):
    """One library's recompute ``which`` past D 2048 into ``out``, a
    no-argument call: ``cuda_xent.walk_on_card`` over the library's own
    pieces where it exports them (at any D), else (a source before the
    walk) its ``icikit_xent_recompute``."""
    from icikit_torch.ops import cuda_xent as cx

    if not hasattr(lib, "icikit_xent_g_cols"):
        return recompute_call(lib, which, x, w, tg, lse, dn, out)
    return lambda: cx.walk_on_card(lib, which, x, w, tg, lse, dn, out)


def _rel(x, y) -> float:
    return float((x.float() - y.float()).abs().max()
                 / y.float().abs().max().clamp_min(1e-30))


def run(a_dir: str, b_dir: str, shape=SHAPE, seed: int = 12) -> bool:
    """Time and compare the two sources; whether B's outputs held to A's
    and to the plain versions for both kernels."""
    from icikit_torch.bench.flash_ab import _turns, event_ms
    from icikit_torch.ops import cuda_xent as cx

    libs = build(a_dir, b_dir)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t, d, v = shape
    bf = torch.bfloat16
    x = torch.randn((t, d), generator=gen, device="cuda").to(bf)
    w = (torch.randn((v, d), generator=gen, device="cuda")
         * d ** -0.5).to(bf)
    tg = torch.randint(0, v, (t,), generator=gen, device="cuda",
                       dtype=torch.int32)
    dn = torch.full((t,), 1.0 / t, device="cuda")
    lse, _ = cx.xent_fwd_plain(x, w, tg, save=False)
    lse = lse.float().contiguous()
    mm_ms = event_ms(lambda: torch.matmul(x, w.t()), ITERS)
    ok = True
    for which in KERNELS:
        rows = t if which == "dx" else v
        outs = {n: torch.empty((rows, d), dtype=bf, device="cuda")
                for n in "AB"}
        fns = {n: {which: recompute_call(libs[n][0], which, x, w, tg, lse,
                                         dn, outs[n])} for n in "AB"}
        ms = _turns(fns, ITERS)
        plain = cx.xent_dx_plain if which == "dx" else cx.xent_dw_plain
        want = plain(x, w, tg, lse, dn)
        plain_ms = event_ms(lambda: plain(x, w, tg, lse, dn), 2)
        bnd, by = bound_ms(which, t, d, v)
        rec = {"kernel": f"xent_{which} (B10 recompute)",
               "shape": {"T": t, "D": d, "V": v}, "dtype": "bfloat16",
               "turns": "A B B A",
               "ms": {n: ms[n][which] for n in "AB"},
               "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
               "cublas_x_wT_ms": mm_ms, "library_ms": None,
               "rel_err": {"b_vs_a": _rel(outs["B"], outs["A"]),
                           "b_vs_plain": _rel(outs["B"], want),
                           "a_vs_plain": _rel(outs["A"], want)},
               "tolerance": TOL}
        rec["ok"] = (rec["rel_err"]["b_vs_a"] <= TOL
                     and rec["rel_err"]["b_vs_plain"] <= TOL)
        print(json.dumps(rec), flush=True)
        ok &= rec["ok"]
        del outs, fns, want
        torch.cuda.empty_cache()
    report(libs, a_dir, b_dir)
    return ok


def saved_call(lib, which: str, e, mrun, other, tg, lse, dn, out):
    """One library's saved ``which`` into ``out``, a no-argument call."""
    t, v = e.shape
    d = other.shape[1]
    st = torch.cuda.current_stream().cuda_stream
    fn = lib.icikit_xent_dx if which == "dx" else lib.icikit_xent_dw
    args = [1, e.data_ptr(), mrun.data_ptr(), other.data_ptr(),
            tg.data_ptr(), lse.data_ptr(), dn.data_ptr(), out.data_ptr(),
            t, v, d, CHUNK, st]
    return lambda: _build.check(fn(*args), f"xent_{which}_saved")


def run_saved(a_dir: str, b_dir: str, shape=SHAPE, seed: int = 14) -> bool:
    """Time and compare the two sources' saved dx and dw; whether B's
    outputs held to A's and to the plain versions for both kernels."""
    from icikit_torch.bench.flash_ab import _turns, event_ms
    from icikit_torch.ops import cuda_xent as cx

    libs = build(a_dir, b_dir, ("xent_dx_bf16", "xent_dw_bf16"))
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t, d, v = shape
    bf = torch.bfloat16
    x = torch.randn((t, d), generator=gen, device="cuda").to(bf)
    w = (torch.randn((v, d), generator=gen, device="cuda")
         * d ** -0.5).to(bf)
    tg = torch.randint(0, v, (t,), generator=gen, device="cuda",
                       dtype=torch.int32)
    dn = torch.full((t,), 1.0 / t, device="cuda")
    lse, _, e, mrun = cx.xent_fwd_plain(x, w, tg, True, CHUNK)
    lse = lse.float().contiguous()
    g = cx.xent_g_saved_plain(e, mrun, tg, lse, dn, CHUNK)   # bf16 (T, V)
    ok = True
    for which, other, mm in (("dx", w, lambda: torch.matmul(g, w)),
                             ("dw", x, lambda: torch.matmul(g.t(), x))):
        rows = t if which == "dx" else v
        outs = {n: torch.empty((rows, d), dtype=bf, device="cuda")
                for n in "AB"}
        fns = {n: {which: saved_call(libs[n][0], which, e, mrun, other, tg,
                                     lse, dn, outs[n])} for n in "AB"}
        ms = _turns(fns, ITERS)
        first = outs["B"].clone()
        fns["B"][which]()
        again = bool(torch.equal(first, outs["B"]))
        plain = (cx.xent_dx_saved_plain if which == "dx"
                 else cx.xent_dw_saved_plain)
        want = plain(e, mrun, other, tg, lse, dn, CHUNK)
        plain_ms = event_ms(lambda: plain(e, mrun, other, tg, lse, dn,
                                          CHUNK), 2)
        mm_ms = event_ms(mm, ITERS)
        bnd, by = saved_bound_ms(which, t, d, v)
        rec = {"kernel": f"xent_{which}_saved (B10 saved)",
               "shape": {"T": t, "D": d, "V": v}, "dtype": "bfloat16",
               "turns": "A B B A",
               "ms": {n: ms[n][which] for n in "AB"},
               "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
               "cublas_g_product_ms": mm_ms,
               "cublas_g_product": "g @ w" if which == "dx" else "g.T @ x",
               "library_ms": None, "b_repeats_bitwise": again,
               "rel_err": {"b_vs_a": _rel(outs["B"], outs["A"]),
                           "b_vs_plain": _rel(outs["B"], want),
                           "a_vs_plain": _rel(outs["A"], want)},
               "tolerance": TOL}
        rec["ok"] = (rec["rel_err"]["b_vs_a"] <= TOL
                     and rec["rel_err"]["b_vs_plain"] <= TOL and again)
        print(json.dumps(rec), flush=True)
        ok &= rec["ok"]
        del outs, fns, want, first
        torch.cuda.empty_cache()
    report(libs, a_dir, b_dir)
    return ok


def _head_inputs(shape, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t, d, v = shape
    bf = torch.bfloat16
    x = torch.randn((t, d), generator=gen, device="cuda").to(bf)
    w = (torch.randn((v, d), generator=gen, device="cuda")
         * d ** -0.5).to(bf)
    tg = torch.randint(0, v, (t,), generator=gen, device="cuda",
                       dtype=torch.int32)
    return x, w, tg


def fwd_call(lib, x, w, tg, save: bool, outs):
    """One library's forward into ``outs`` (lse, tgt, e, mrun, lpart,
    tpart, counter), a no-argument call; the kernel leaves its counter at
    zero for the next call."""
    t, d = x.shape
    v = w.shape[0]
    lse, tgt, e, mrun, lpart, tpart, counter = outs
    st = torch.cuda.current_stream().cuda_stream
    args = [1, x.data_ptr(), w.data_ptr(), tg.data_ptr(), e.data_ptr(),
            mrun.data_ptr(), lpart.data_ptr(), tpart.data_ptr(),
            counter.data_ptr(), lse.data_ptr(), tgt.data_ptr(), t, v, d,
            int(save), st]
    return lambda: _build.check(lib.icikit_xent_fwd(*args), "xent_fwd")


def _fwd_outs(t, v):
    nc = -(-v // CHUNK)
    f32 = dict(dtype=torch.float32, device="cuda")
    return [torch.empty((t,), **f32), torch.empty((t,), **f32),
            torch.empty((t, v), dtype=torch.bfloat16, device="cuda"),
            *(torch.empty((nc, t), **f32) for _ in range(3)),
            torch.zeros((-(-t // CHUNK),), dtype=torch.int32, device="cuda")]


def run_fwd(a_dir: str, b_dir: str, shape=SHAPE, seed: int = 15) -> bool:
    """Time and compare the two sources' forward with save on and off;
    whether B's outputs held to A's and to the plain version."""
    from icikit_torch.bench.flash_ab import _turns, event_ms
    from icikit_torch.ops import cuda_xent as cx

    libs = build(a_dir, b_dir, ("xent_fwd_bf16",))
    torch.backends.cuda.matmul.allow_tf32 = False
    t, d, v = shape
    x, w, tg = _head_inputs(shape, seed)
    mm_ms = event_ms(lambda: torch.matmul(x, w.t()), ITERS)
    ok = True
    for save in (True, False):
        outs = {n: _fwd_outs(t, v) for n in "AB"}
        fns = {n: {"fwd": fwd_call(libs[n][0], x, w, tg, save, outs[n])}
               for n in "AB"}
        ms = _turns(fns, ITERS)
        first = [o.clone() for o in outs["B"][:4]]
        fns["B"]["fwd"]()
        again = all(bool(torch.equal(a, b))
                    for a, b in zip(first, outs["B"][:4]))
        want = cx.xent_fwd_plain(x, w, tg, True, CHUNK)
        plain_ms = event_ms(lambda: cx.xent_fwd_plain(x, w, tg, save,
                                                      CHUNK), 2)
        err = {}
        for n in "AB":
            lse, tgt, e, mrun = outs[n][:4]
            err[f"{n.lower()}_vs_plain"] = {
                "lse": float((lse - want[0]).abs().max()),
                "tgt": float((tgt - want[1]).abs().max())}
            if save:
                err[f"{n.lower()}_vs_plain"].update(
                    e=_rel(e, want[2]),
                    mrun=float((mrun - want[3]).abs().max()))
        err["b_vs_a"] = {"lse": float((outs["B"][0] - outs["A"][0])
                                      .abs().max())}
        if save:
            err["b_vs_a"]["e"] = _rel(outs["B"][2], outs["A"][2])
        bnd, by = fwd_bound_ms(save, t, d, v)
        rec = {"kernel": f"xent_fwd (B9), save={save}",
               "shape": {"T": t, "D": d, "V": v}, "dtype": "bfloat16",
               "turns": "A B B A", "ms": {n: ms[n]["fwd"] for n in "AB"},
               "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
               "cublas_x_wT_ms": mm_ms,
               "cublas_x_wT": "x @ w.T, bf16 out: the same product, not "
                              "the same function",
               "library_ms": None, "b_repeats_bitwise": again,
               "err": err, "tolerance": {"lse": LSE_TOL, "e": TOL,
                                         "mrun": LSE_TOL}}
        rec["ok"] = again and all(
            val <= (TOL if key == "e" else LSE_TOL)
            for side in ("b_vs_plain", "b_vs_a")
            for key, val in err[side].items())
        print(json.dumps(rec), flush=True)
        ok &= rec["ok"]
        del outs, fns, want, first
        torch.cuda.empty_cache()
    report(libs, a_dir, b_dir)
    return ok


def g_call(lib, x, w, tg, lse, dn, out):
    """One library's recomputed g into ``out``, a no-argument call."""
    t, d = x.shape
    v = w.shape[0]
    st = torch.cuda.current_stream().cuda_stream
    args = [1, x.data_ptr(), w.data_ptr(), tg.data_ptr(), lse.data_ptr(),
            dn.data_ptr(), out.data_ptr(), t, v, d, st]
    return lambda: _build.check(lib.icikit_xent_g(*args), "xent_g")


def run_g(a_dir: str, b_dir: str, shape=SHAPE, seed: int = 16) -> bool:
    """Time and compare the two sources' recomputed g; whether B's g held
    to A's and to the plain version."""
    from icikit_torch.bench.flash_ab import _turns, event_ms
    from icikit_torch.ops import cuda_xent as cx

    libs = build(a_dir, b_dir, ("xent_g_bf16",))
    torch.backends.cuda.matmul.allow_tf32 = False
    t, d, v = shape
    x, w, tg = _head_inputs(shape, seed)
    dn = torch.full((t,), 1.0 / t, device="cuda")
    lse = cx.xent_fwd_plain(x, w, tg, False)[0].float().contiguous()
    mm_ms = event_ms(lambda: torch.matmul(x, w.t()), ITERS)
    outs = {n: torch.empty((t, v), dtype=torch.bfloat16, device="cuda")
            for n in "AB"}
    fns = {n: {"g": g_call(libs[n][0], x, w, tg, lse, dn, outs[n])}
           for n in "AB"}
    ms = _turns(fns, ITERS)
    first = outs["B"].clone()
    fns["B"]["g"]()
    again = bool(torch.equal(first, outs["B"]))
    want = cx.xent_g_plain(x, w, tg, lse, dn)
    plain_ms = event_ms(lambda: cx.xent_g_plain(x, w, tg, lse, dn), 2)
    bnd, by = g_bound_ms(t, d, v)
    rec = {"kernel": "xent_g (B11 recompute)",
           "shape": {"T": t, "D": d, "V": v}, "dtype": "bfloat16",
           "turns": "A B B A", "ms": {n: ms[n]["g"] for n in "AB"},
           "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
           "cublas_x_wT_ms": mm_ms,
           "cublas_x_wT": "x @ w.T, bf16 out: the same product and output "
                          "bytes, not the same function",
           "library_ms": None, "b_repeats_bitwise": again,
           "rel_err": {"b_vs_a": _rel(outs["B"], outs["A"]),
                       "b_vs_plain": _rel(outs["B"], want),
                       "a_vs_plain": _rel(outs["A"], want)},
           "tolerance": TOL}
    rec["ok"] = (rec["rel_err"]["b_vs_a"] <= TOL
                 and rec["rel_err"]["b_vs_plain"] <= TOL and again)
    print(json.dumps(rec), flush=True)
    report(libs, a_dir, b_dir)
    return rec["ok"]


def run_wide(a_dir: str, b_dir: str, seed: int = 18) -> bool:
    """Time and compare the two sources' recompute dx and dw at
    WIDE_SHAPE, then B's walk against B's cluster kernel at the base
    shape; whether every output held to the plain versions and B to A."""
    from icikit_torch.bench.flash_ab import _turns, event_ms
    from icikit_torch.ops import cuda_xent as cx
    from icikit_torch.utils.trace import device_activity

    libs = build(a_dir, b_dir, ("xent_recompute_bf16", "xent_g_bf16",
                                "xent_dx_g_bf16", "xent_dw_g_bf16"))
    torch.backends.cuda.matmul.allow_tf32 = False
    ok = True
    for shape, arms in ((WIDE_SHAPE, ("A", "B")), (SHAPE, ("cluster",
                                                            "walk"))):
        t, d, v = shape
        x, w, tg = _head_inputs(shape, seed)
        dn = torch.full((t,), 1.0 / t, device="cuda")
        lse = cx.xent_fwd_plain(x, w, tg, False)[0].float().contiguous()
        for which in KERNELS:
            rows = t if which == "dx" else v
            outs = {n: torch.empty((rows, d), dtype=torch.bfloat16,
                                   device="cuda") for n in "AB"}
            def call(n, ls, out):
                if arms[0] == "A":
                    return walk_call(libs[n][0], which, x, w, tg, ls, dn, out)
                # B's cluster kernel as A, B's walk as B
                make = recompute_call if n == "A" else walk_call
                return make(libs["B"][0], which, x, w, tg, ls, dn, out)

            fns = {n: {which: call(n, lse, outs[n])} for n in "AB"}
            ms = _turns(fns, WIDE_ITERS)
            act = device_activity(fns["B"][which], attempts=4)
            plain = cx.xent_dx_plain if which == "dx" else cx.xent_dw_plain
            want = plain(x, w, tg, lse, dn)
            plain_ms = event_ms(lambda: plain(x, w, tg, lse, dn), 1)
            # lse less log V: g's softmax part outweighs the -dnll at a
            # row's target, which hides it at the true lse
            ls = lse - math.log(v)
            want_s = plain(x, w, tg, ls, dn)
            shifted = {}
            for n in "AB":
                o = torch.empty_like(outs[n])
                call(n, ls, o)()
                shifted[f"{n.lower()}_vs_plain_lse_less_log_v"] = _rel(
                    o, want_s)
            del o, want_s
            bnd, by = bound_ms(which, t, d, v)
            rec = {"kernel": f"xent_{which} (B10 recompute)",
                   "shape": {"T": t, "D": d, "V": v}, "dtype": "bfloat16",
                   "arms": {"A": arms[0], "B": arms[1]},
                   "turns": "A B B A",
                   "ms": {n: ms[n][which] for n in "AB"},
                   "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
                   "library_ms": None,
                   "b_trace": act["by_name"],
                   "b_trace_lost_device_events": act["lost_device_events"],
                   "rel_err": {"b_vs_a": _rel(outs["B"], outs["A"]),
                               "b_vs_plain": _rel(outs["B"], want),
                               "a_vs_plain": _rel(outs["A"], want),
                               **shifted},
                   "tolerance": TOL}
            rec["ok"] = all(rec["rel_err"][k] <= TOL for k in rec["rel_err"])
            print(json.dumps(rec), flush=True)
            ok &= rec["ok"]
            del outs, fns, want
            torch.cuda.empty_cache()
        del x, w, tg, dn, lse
    report(libs, a_dir, b_dir)
    return ok


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--a", required=True, help="directory of arm A's xent.cu")
    p.add_argument("--b", required=True, help="the same for arm B")
    p.add_argument("--flavour", default="recompute", choices=FLAVOURS,
                   help="the recompute head's backward (the default), the "
                        "saved one's, the forward (fwd), the matmul "
                        "backward's recomputed g (g) or the recompute "
                        "head's backward past D 2048 (wide)")
    p.add_argument("--timing-only", action="store_true",
                   help="exit 0 even where B's outputs depart from A's")
    args = p.parse_args(argv)
    missing = [os.path.join(d, "xent.cu") for d in (args.a, args.b)
               if not os.path.isfile(os.path.join(d, "xent.cu"))]
    if missing:
        p.error(f"missing sources: {missing}")
    if not torch.cuda.is_available():
        raise SystemExit("xent_ab needs a CUDA card")
    runner = {"recompute": run, "saved": run_saved, "fwd": run_fwd,
              "g": run_g, "wide": run_wide}[args.flavour]
    ok = runner(args.a, args.b)
    return 0 if ok or args.timing_only else 1


if __name__ == "__main__":
    raise SystemExit(main())
