"""The one-pass Adam (B12) and the save-stack copies (B16) of two source
directories, timed in turns on one card, beside like-for-like yardsticks.

Builds ``adam.cu`` and ``stack_write.cu`` of each directory with ``nvcc``
(for ``sm_90a``, ``-Xptxas -v``) through ``ops._build.build_sources``
into ``icikit_torch/build/ab/`` (named by a hash of the source and the
flags), then times source A, B, B, A in one process, by CUDA events over
launches queued behind a sleep kernel, so that the host's call rate
never shows in a device time:

- Adam over the ``base`` preset's tree (10 leaves, float32 moments), at
  the train step's gradient dtypes (bf16 for the matmul weights,
  ``NARROW_OK``; float32 for the rest) and at float32 gradients on every
  leaf; and on ``bench/adam.py``'s 211 M-parameter leaf at bf16 and
  float32 gradients. A library that exports ``icikit_adam_tree`` takes
  the tree entry (one launch for up to 48 leaves); one that does not
  (the per-leaf design before it) takes ``icikit_adam`` once a leaf.
- The slice copies cold: ``stack_write`` and ``stack_read`` over the 12
  slices of a (12, 8, 1024, 1024) bf16 stack in rotation (192 MiB, past
  the 50 MB L2), the read into a preallocated slice.

Beside them, timed the same way: ``torch._fused_adam_`` on the same tree
and leaf with float32 gradients (28 B an element); ``stack[i].copy_(x)``
and ``out.copy_(stack[i])`` over the same rotation; ``dst.copy_(src)``
of 1 GiB, the card's streaming rate against its 3.35 TB/s nameplate. And
the host's time a call, the host clock around 1,000 calls on a (12, 16,
128) bf16 stack (4 KiB slices: the device is never the limit) of the
working tree's package: ``ops.stack_write.stack_write`` (every check a
call), the layer loop's checked-once ``cuda_stack.SliceCopier`` and
``stack[i].copy_(x)``; the reads likewise.

Bounds: each input read and each output written once at 3.35 TB/s. B is
held to A bit for bit (the parameters and moments after one update from
one state; the stack after a write; a read's slice): a departure marks
the record ``"ok": false`` and exits 1 unless ``--timing-only``. Prints
one JSON line a shape, the kernels' registers and spills as ptxas
reported them, and the card's name and power limit. Needs a CUDA card.

    python -m icikit_torch.bench.stream_ab --a OLD_DIR --b icikit_torch/csrc
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import os
import subprocess
import time

import torch

from icikit_torch.ops import _build

MEM_BPS = 3.35e12          # H100 SXM HBM3, NVIDIA's data sheet
STACK = (12, 8, 1024, 1024)   # the base step's residual stack, bf16
HOST_STACK = (12, 16, 128)
HOST_CALLS = 1000
COPY_BYTES = 1 << 30
LEAF_M = 211.0             # bench/adam.py's leaf, millions of elements
SLEEP_CYCLES_PER_MS = 2_000_000   # the SM clock's order: a head start
ROTATE_BYTES = 256 << 20   # operand copies a cold timing walks through,
                           # five times the card's 50 MB L2
# the per-leaf C entry of the design before the tree entry
_LEAF_ENTRY = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6 + [
    ctypes.c_int64] + [ctypes.c_float] * 5 + [ctypes.c_void_p]


def bound_ms(nbytes: float) -> float:
    return nbytes / MEM_BPS * 1e3


def adam_bytes(ps, gs, moment_bytes: int = 4) -> int:
    """Bytes of one Adam pass: p, m and v read and written, g read."""
    return sum(p.numel() * (8 + 4 * moment_bytes + g.element_size())
               for p, g in zip(ps, gs))


def _ptxas_regs(log: str) -> dict:
    from icikit_torch.bench.flash_ab import _ptxas_regs as regs
    return regs(log, lambda name: "adam" in name or "stack_" in name)


def build(a_dir: str, b_dir: str) -> dict:
    """{"A"/"B": {"adam": library, "stack_write": library, "regs":
    {kernel: (registers, spill bytes)}}}, each library's two sources
    compiled in parallel."""
    out = os.path.join(_build.BUILD_DIR, "ab")
    libs = {"A": {"regs": {}}, "B": {"regs": {}}}
    for name in ("adam", "stack_write"):
        built = _build.build_sources(
            name, {n: os.path.join(d, f"{name}.cu")
                   for n, d in (("A", a_dir), ("B", b_dir))},
            out, ("-Xptxas", "-v"))
        for n, (lib, log) in built.items():
            libs[n][name] = lib
            libs[n]["regs"].update(_ptxas_regs(log))
    return libs


def copies_past_l2(nbytes: int) -> int:
    """Copies of an operand of ``nbytes`` that pass ROTATE_BYTES, so
    that a timing walking through them reads device memory."""
    return max(2, -(-ROTATE_BYTES // nbytes))


def rotating(call, operands):
    """A no-argument call that runs ``call(op)`` on the next of
    ``operands`` each time."""
    it = itertools.cycle(operands)
    return lambda: call(next(it))


def device_ms(fn, iters: int, host_us: float = 30.0) -> float:
    """Mean device ms of ``fn()`` over ``iters`` calls queued behind a
    sleep kernel long enough for the host to enqueue them all."""
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(int(iters * host_us * 1e-3 * SLEEP_CYCLES_PER_MS))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def _turns(fns: dict, iters: int, host_us: float = 30.0) -> dict:
    """{source: [ms, ms]} timed A, B, B, A."""
    ms = {n: [] for n in fns}
    for n in "ABBA":
        ms[n].append(device_ms(fns[n], iters, host_us))
    return ms


def adam_fn(lib, ps, ms, vs, gs, sc):
    """One Adam pass of library ``lib`` over the leaves, a no-argument
    call returning its launches."""
    from icikit_torch.ops import cuda_adam

    st = torch.cuda.current_stream().cuda_stream
    if hasattr(lib, "icikit_adam_tree"):
        return lambda: cuda_adam._launch(lib.icikit_adam_tree, ps, ms, vs,
                                         gs, sc, 0.9, 0.999, 1e-8, None, st)
    entry = lib.icikit_adam
    entry.argtypes, entry.restype = _LEAF_ENTRY, ctypes.c_int
    calls = [(cuda_adam._MOMENT_CODE[(m.dtype, v.dtype)],
              cuda_adam._GRAD_CODE[g.dtype],
              p.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(),
              sc.data_ptr(), None, p.numel(), 0.9, 1.0 - 0.9, 0.999,
              1.0 - 0.999, 1e-8, st) for p, m, v, g in zip(ps, ms, vs, gs)]

    def run():
        for args in calls:
            _build.check(entry(*args), "adam launch")
        return len(calls)
    return run


def _fused_adam(ps, ms, vs, gs32):
    steps = [torch.ones((), device="cuda") for _ in ps]
    return lambda: torch._fused_adam_(
        ps, gs32, ms, vs, [], steps, amsgrad=False, lr=1e-4, beta1=0.9,
        beta2=0.999, weight_decay=0.0, eps=1e-8, maximize=False)


def run_adam(libs, tag: str, ps, gs, iters: int) -> dict:
    """One Adam record: the tree or leaf ``ps`` (float32, float32
    moments) with gradients ``gs``."""
    from icikit_torch.ops.adam import adam_scalars

    sc = adam_scalars(1e-4, torch.tensor(3, device="cuda"))
    state = {n: ([p.clone() for p in ps], [torch.zeros_like(p) for p in ps],
                 [torch.zeros_like(p) for p in ps]) for n in "AB"}
    fns = {n: adam_fn(libs[n]["adam"], *state[n], gs, sc) for n in "AB"}
    # B against A: one pass each from the same state
    m0 = [torch.randn_like(p) * 0.01 for p in ps]
    v0 = [torch.rand_like(p) * 1e-4 for p in ps]
    once = {n: ([p.clone() for p in ps], [m.clone() for m in m0],
                [v.clone() for v in v0]) for n in "AB"}
    del m0, v0
    launches = {n: adam_fn(libs[n]["adam"], *once[n], gs, sc)() for n in "AB"}
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for a, b in zip(once["A"], once["B"])
               for x, y in zip(a, b))
    del once
    nbytes = adam_bytes(ps, gs)
    rec = {"what": "adam", "shape": tag,
           "grads": sorted({str(g.dtype) for g in gs}),
           "leaves": len(ps), "elements": sum(p.numel() for p in ps),
           "turns": "A B B A", "ms": _turns(fns, iters, 300.0),
           "launches": launches, "bytes": nbytes,
           "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
           "b_vs_a_bitwise": same, "ok": same}
    if all(g.dtype == torch.float32 for g in gs):
        lib_state = ([p.clone() for p in ps], [torch.zeros_like(p)
                                               for p in ps],
                     [torch.zeros_like(p) for p in ps])
        rec["library"] = "torch._fused_adam_, float32 gradients"
        rec["library_ms"] = device_ms(_fused_adam(*lib_state, list(gs)),
                                      iters, 300.0)
        del lib_state
    rec["tb_per_s"] = {n: nbytes / (min(v) * 1e-3) / 1e12
                       for n, v in rec["ms"].items()}
    del state, fns
    torch.cuda.empty_cache()
    return rec


def run_stack(libs, gen, iters: int) -> list:
    """The cold rotating copies of both sources beside copy_."""
    n = STACK[0]
    stack0 = torch.randn(STACK, generator=gen, device="cuda").to(
        torch.bfloat16)
    stacks = {k: stack0.clone() for k in ("A", "B", "lib")}
    del stack0
    x = torch.randn(STACK[1:], generator=gen, device="cuda").to(
        torch.bfloat16)
    outs = {k: torch.empty_like(x) for k in ("A", "B", "lib")}
    nbytes = x.numel() * 2
    st = torch.cuda.current_stream().cuda_stream
    recs = []
    for key in ("stack_write", "stack_read"):
        def kern(name, key=key):
            lib = libs[name]["stack_write"]
            ptr = stacks[name].data_ptr()
            it = itertools.cycle(range(n))
            if key == "stack_write":
                entry, other = lib.icikit_stack_write, x.data_ptr()
            else:
                entry, other = lib.icikit_stack_read, outs[name].data_ptr()
            return lambda: entry(ptr, other, next(it), n, nbytes, st)
        fns = {name: kern(name) for name in "AB"}
        it = itertools.cycle(range(n))
        s_lib, o_lib = stacks["lib"], outs["lib"]
        lib_fn = ((lambda: s_lib[next(it)].copy_(x)) if key == "stack_write"
                  else (lambda: o_lib.copy_(s_lib[next(it)])))
        for name in "AB":   # B against A: the same slice, one call each
            entry = (libs[name]["stack_write"].icikit_stack_write
                     if key == "stack_write"
                     else libs[name]["stack_write"].icikit_stack_read)
            other = x if key == "stack_write" else outs[name]
            _build.check(entry(stacks[name].data_ptr(), other.data_ptr(), 5,
                               n, nbytes, st), key)
        torch.cuda.synchronize()
        same = (torch.equal(stacks["A"].view(torch.int16),
                            stacks["B"].view(torch.int16))
                if key == "stack_write" else
                torch.equal(outs["A"].view(torch.int16),
                            outs["B"].view(torch.int16)))
        recs.append({"what": key, "shape": list(STACK[1:]),
                     "stack": list(STACK), "dtype": "bfloat16",
                     "rotation": f"the {n} slices in turn (cold)",
                     "turns": "A B B A", "ms": _turns(fns, iters),
                     "library": ("stack[i].copy_(x)" if key == "stack_write"
                                 else "out.copy_(stack[i]), out "
                                      "preallocated"),
                     "library_ms": device_ms(lib_fn, iters),
                     "bound_ms": bound_ms(2 * nbytes), "bound_by": "bytes",
                     "b_vs_a_bitwise": bool(same), "ok": bool(same)})
    del stacks, x, outs
    torch.cuda.empty_cache()
    return recs


def host_us(fn, calls: int = HOST_CALLS) -> float:
    """Host microseconds a call of ``fn(i)`` over ``calls`` calls, the
    slice index in rotation."""
    fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(calls):
        fn(k % HOST_STACK[0])
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def run_host(gen) -> dict:
    """The host's time a call of the working tree's slice copies."""
    from icikit_torch.ops import cuda_stack
    from icikit_torch.ops import stack_write as sw

    stack = torch.randn(HOST_STACK, generator=gen, device="cuda").to(
        torch.bfloat16)
    x = torch.randn(HOST_STACK[1:], generator=gen, device="cuda").to(
        torch.bfloat16)
    out = torch.empty_like(x)
    cp = cuda_stack.SliceCopier(stack)
    rows = {
        "write: ops.stack_write.stack_write": lambda i: sw.stack_write(
            stack, x, i),
        "write: SliceCopier.write (checked once)": lambda i: cp.write(x, i),
        "write: stack[i].copy_(x)": lambda i: stack[i].copy_(x),
        "read: ops.stack_write.stack_read": lambda i: sw.stack_read(stack, i),
        "read: SliceCopier.read (checked once, allocates)":
            lambda i: cp.read(i),
        "read: stack[i].clone()": lambda i: stack[i].clone(),
        "read: out.copy_(stack[i])": lambda i: out.copy_(stack[i])}
    us = {}
    for _ in range(2):      # two rounds, in turns: the host drifts
        for name, fn in rows.items():
            us.setdefault(name, []).append(host_us(fn))
    return {"what": "host", "shape": list(HOST_STACK[1:]),
            "stack": list(HOST_STACK), "dtype": "bfloat16",
            "calls": HOST_CALLS, "us_a_call": us,
            "source": "the working tree's package (icikit_torch/csrc)"}


def run_copy() -> dict:
    """The card's streaming rate: dst.copy_(src) of 1 GiB."""
    src = torch.empty(COPY_BYTES, dtype=torch.uint8, device="cuda").fill_(1)
    dst = torch.empty_like(src)
    ms = [device_ms(lambda: dst.copy_(src), 10) for _ in range(3)]
    del src, dst
    torch.cuda.empty_cache()
    return {"what": "copy", "bytes": COPY_BYTES, "ms": ms,
            "gb_per_s": [2 * COPY_BYTES / (t * 1e-3) / 1e9 for t in ms],
            "nameplate_gb_per_s": MEM_BPS / 1e9}


def _base_tree(gen):
    """The base preset's parameters and gradients at the step's dtypes
    (matmul weights bf16) and at float32."""
    from icikit_torch.bench.train import PRESETS
    from icikit_torch.models.transformer import (TransformerConfig,
                                                 init_params)
    from icikit_torch.models.transformer.model import NARROW_OK

    params = init_params(TransformerConfig(**PRESETS["base"]), gen, "cuda")
    g32 = {k: torch.randn(p.shape, generator=gen, device="cuda")
           for k, p in params.items()}
    step = {k: g.to(torch.bfloat16) if k in NARROW_OK else g
            for k, g in g32.items()}
    keys = list(params)
    return ([params[k] for k in keys], [step[k] for k in keys],
            [g32[k] for k in keys])


def run(a_dir: str, b_dir: str, seed: int = 9) -> bool:
    """Time and compare the two sources; whether B held to A bit for bit
    everywhere."""
    libs = build(a_dir, b_dir)
    torch.manual_seed(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    recs = [run_copy()]
    ps, g_step, g32 = _base_tree(gen)
    recs.append(run_adam(libs, "base tree", ps, g_step, 10))
    recs.append(run_adam(libs, "base tree", ps, g32, 10))
    del ps, g_step, g32
    rows = int(LEAF_M * 1e6) // 128
    p = torch.randn((rows, 128), generator=gen, device="cuda")
    for gdt in (torch.bfloat16, torch.float32):
        g = torch.randn((rows, 128), generator=gen, device="cuda").to(gdt)
        recs.append(run_adam(libs, f"{LEAF_M:g}M leaf", [p], [g], 10))
        del g
    del p
    torch.cuda.empty_cache()
    recs += run_stack(libs, gen, 240)
    recs.append(run_host(gen))
    ok = True
    for rec in recs:
        print(json.dumps(rec), flush=True)
        ok &= rec.get("ok", True)
    print(json.dumps({"registers_spill_bytes": {
        n: libs[n]["regs"] for n in "AB"}, "sources": {"A": a_dir,
                                                      "B": b_dir}}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip())
    return ok


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--a", required=True,
                   help="directory of arm A's adam.cu and stack_write.cu")
    p.add_argument("--b", required=True, help="the same for arm B")
    p.add_argument("--timing-only", action="store_true",
                   help="exit 0 even where B's outputs depart from A's")
    args = p.parse_args(argv)
    missing = [os.path.join(d, f) for d in (args.a, args.b)
               for f in ("adam.cu", "stack_write.cu")
               if not os.path.isfile(os.path.join(d, f))]
    if missing:
        p.error(f"missing sources: {missing}")
    if not torch.cuda.is_available():
        raise SystemExit("stream_ab needs a CUDA card")
    ok = run(args.a, args.b)
    return 0 if ok or args.timing_only else 1


if __name__ == "__main__":
    raise SystemExit(main())
