"""Bitonic sorting networks on Hopper: two CUDA kernels and their drivers.

The port of ``icikit/ops/pallas_sort.py``. A library sort of n keys
crosses device memory many times; these kernels run every stage whose
stride fits in a tile *inside* the tile, so the array crosses device
memory once per *group* of stages:

- K1 ``net_pass`` (``csrc/bitonic_net.cu`` ``net_kernel``, replaces
  ``_net_call``): one CTA per tile of up to 2^15 keys, 32 keys a
  thread; all stages with stride < tile, back to back, as min/max
  pairs inside a thread's registers, the keys moved between three
  register windows through shared memory.
- K2 ``cross_pass`` (``cross_kernel``, replaces ``_cross_call``): the
  stages of one merge round with stride >= tile whose Q-axis bits lie in
  [lo, hi] (at most ``G_MAX_KERNEL`` of them), in one pass over a
  (n/span, A, G, B*tile) view; a CTA takes 2^14 keys, 2^G rows of
  2^(14-G) columns.

Direction (``pallas_sort.py:27-40``): every stage is a plain ascending
compare-exchange; descending spans are order-reversed at round
boundaries, the flip bit being a bit of the element's global index. The
plain versions reverse by ``~x`` for int32 and ``-x`` for float32; the
kernels sort float32 keys as the int32 image of their bit pattern
(``x ^ ((x >> 31) & 0x7fffffff)``, order-preserving) and reverse by
``~x`` for both. uint32 rides the int32 kernel through the
order-preserving bijection ``u ^ 0x80000000``; bf16/f16 are widened
exactly to float32. Below ``MIN_KERNEL`` elements, and with
``backend="torch"``, the sort is ``torch.sort``, as the JAX package
calls ``jnp.sort`` there. NaN order follows min/max, so callers with
NaNs pass ``backend="torch"``; -0.0 and 0.0 compare equal: the plain
versions keep them in an arbitrary relative order, the kernels put -0.0
first, and the values agree.

Each kernel has a plain PyTorch version beside it (``net_pass_plain``,
``cross_pass_plain``): the same rounds and flips as stage-by-stage
tensor ops over the whole array, independent of the tile geometry. A
wrapper takes it only for a tensor on the CPU; for a CUDA tensor it
launches the kernel or raises.

Geometry differs from the TPU's (T_GRID 2^15, T_BIG 2^17, G_MAX 11 in
VMEM): a CTA holds at most 227 KB of shared memory, so K1 takes tiles of
up to 2^15 int32 (128 KiB). The default, T_GRID = T_BIG = 2^14 and
G_MAX 10 with each round's cross stages split evenly (33 launches at
2^28), gave the fastest whole sort on an H100 among the geometries
tried (``bench/sort_ab.py``; ``PERF.md``): a 2^15 tile saves three
launches but holds one CTA an SM, whose round passes ran 1.5x slower.
The network, and so the output, does not depend on the geometry.
"""

from __future__ import annotations

import ctypes

import torch

from icikit_torch.ops import _build
from icikit_torch.utils.dtypes import sentinel_for
from icikit_torch.utils.mesh import ilog2, is_pow2

T_GRID = 1 << 14
T_BIG = 1 << 14
G_MAX = 10

# Below this size the launches lose to one library sort (the
# reference's MIN_PALLAS).
MIN_KERNEL = 1 << 13

# K1 holds 32 keys a thread, 32 to 1024 threads a tile; K2 a block of
# CROSS_ELEMS keys, 2^G rows for G up to G_MAX_KERNEL.
NET_TILE_MIN = 1 << 10
NET_TILE_MAX = 1 << 15
CROSS_ELEMS = 1 << 14
G_MAX_KERNEL = 10

_KERNEL_DTYPES = (torch.int32, torch.uint32, torch.float32)
_DTYPE_CODE = {torch.int32: 0, torch.float32: 1}

LAUNCHES = {"net": 0, "cross": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def kernel_supported(dtype: torch.dtype, n: int) -> bool:
    return dtype in _KERNEL_DTYPES and n >= MIN_KERNEL


def _u32_as_i32(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving bijection uint32 -> int32 (the kernels sort the
    signed image)."""
    return x.view(torch.int32) ^ torch.iinfo(torch.int32).min


def _i32_as_u32(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_u32_as_i32`."""
    return (x ^ torch.iinfo(torch.int32).min).view(torch.uint32)


# ---------------------------------------------------------------------------
# Round schedules: (db, strides); every stage of an entry runs as a
# plain ascending merge under the flip of bit ``db`` (None = ascending).


def _sort_rounds(log2n: int):
    """Every round of a full bitonic sort of 2^log2n elements: round i
    has strides 2^i..1, direction bit i+1 (psort.cc:184-195)."""
    return [(i + 1, tuple(1 << j for j in range(i, -1, -1)))
            for i in range(log2n)]


def _one_round(i: int, lo_stride: int = 1):
    """Merge round i with strides >= lo_stride, direction bit i+1."""
    return [(i + 1, tuple(1 << j
                          for j in range(i, ilog2(lo_stride) - 1, -1)))]


def _merge_rounds(hi_stride: int, lo_stride: int = 1):
    """Ascending-everywhere merge (for merging a bitonic input)."""
    return [(None, tuple(1 << j
                         for j in range(ilog2(hi_stride),
                                        ilog2(lo_stride) - 1, -1)))]


# ---------------------------------------------------------------------------
# Plain versions: whole-array tensor ops, any device.


def _dir_bits(n: int, db, device):
    if db is None:
        return None
    return (torch.arange(n, device=device) >> db) & 1


def _xor_bits(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a ^ b


def _flip(x: torch.Tensor, bit) -> torch.Tensor:
    """Order-reverse x where bit == 1: NOT for int32, negation for
    float32; exact and involutive."""
    if bit is None:
        return x
    if x.dtype == torch.float32:
        return torch.where(bit.bool(), -x, x)
    return x ^ (-bit).to(x.dtype)


def _ce_stage(x: torch.Tensor, k: int) -> torch.Tensor:
    """Plain ascending compare-exchange of every pair (e, e + k), e with
    bit k clear. Equal keys keep their places, as in the kernels."""
    y = x.view(-1, 2, k)
    a, b = y[:, 0], y[:, 1]
    swap = b < a
    return torch.stack([torch.where(swap, b, a), torch.where(swap, a, b)],
                       dim=1).reshape(-1)


def net_pass_plain(x: torch.Tensor, tile: int, rounds) -> torch.Tensor:
    """Plain version of K1: the rounds over the whole array. ``tile``
    only bounds the strides; the result does not depend on it."""
    n = x.shape[0]
    prev = None
    for db, strides in rounds:
        if max(strides, default=0) >= tile:
            raise ValueError(f"stride {max(strides)} >= tile {tile}")
        cur = _dir_bits(n, db, x.device)
        x = _flip(x, _xor_bits(prev, cur))
        prev = cur
        for k in strides:
            x = _ce_stage(x, k)
    return _flip(x, prev)


def _cross_strides(tile: int, lo_bit: int, hi_bit: int):
    return [tile << d for d in range(hi_bit, lo_bit - 1, -1)]


def cross_pass_plain(x: torch.Tensor, span: int, tile: int, lo_bit: int,
                     hi_bit: int, merge_only: bool) -> torch.Tensor:
    """Plain version of K2: the stages of stride tile*2^hi .. tile*2^lo
    under the round's whole-span flip (span-index parity)."""
    desc = None if merge_only else _dir_bits(x.shape[0], ilog2(span),
                                             x.device)
    x = _flip(x, desc)
    for k in _cross_strides(tile, lo_bit, hi_bit):
        x = _ce_stage(x, k)
    return _flip(x, desc)


# ---------------------------------------------------------------------------
# Kernel wrappers.


def _check_cuda(x: torch.Tensor, out, what: str) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA or CPU tensor, got "
                         f"{x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"{what}: kernel takes int32/float32, got {x.dtype}")
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous 1-D tensor")
    if out is None:
        return torch.empty_like(x)
    if (out.shape != x.shape or out.dtype != x.dtype
            or out.device != x.device or not out.is_contiguous()):
        raise ValueError(f"{what}: out must match x")
    return out


def round_arrays(rounds):
    """K1's C arrays for ``rounds``: each round's direction bit (-1:
    ascending) and log2 of its first and last stride."""
    db = (ctypes.c_int * 32)(*[-1 if d is None else d for d, _ in rounds])
    hi = (ctypes.c_int * 32)(*[ilog2(s[0]) if s else 0 for _, s in rounds])
    lo = (ctypes.c_int * 32)(*[ilog2(s[-1]) if s else 1 for _, s in rounds])
    return db, hi, lo


def net_pass(x: torch.Tensor, tile: int, rounds, out=None) -> torch.Tensor:
    """K1, replacing ``icikit/ops/pallas_sort.py`` ``_net_call``
    (pallas_call at :206): every round in ``rounds`` on each tile of
    ``tile`` elements, in one launch. ``out`` may be ``x`` (in place).

    Bound: one read and one write of x, 2 * n * 4 bytes over the card's
    memory rate. CPU tensors take :func:`net_pass_plain`."""
    rounds = [(db, tuple(s)) for db, s in rounds]
    n = x.shape[0]
    if not is_pow2(tile) or n % tile:
        raise ValueError(f"net_pass: tile {tile} must be a power of two "
                         f"dividing n={n}")
    if x.device.type == "cpu":
        res = net_pass_plain(x, tile, rounds)
        return res if out is None else out.copy_(res)
    out = _check_cuda(x, out, "net_pass")
    if not NET_TILE_MIN <= tile <= NET_TILE_MAX:
        raise ValueError(f"net_pass: tile {tile} outside the kernel's "
                         f"[{NET_TILE_MIN}, {NET_TILE_MAX}]")
    if len(rounds) > 32:
        raise ValueError("net_pass: at most 32 rounds per launch")
    for _, s in rounds:
        if s and (s[0] >= tile or not is_pow2(s[0]) or list(s) != [
                s[0] >> i for i in range(len(s))]):
            raise ValueError(f"net_pass: strides {s} must descend by "
                             f"halves below the tile {tile}")
    db, hi, lo = round_arrays(rounds)
    lib = _build.load("bitonic_net")
    rc = lib.icikit_net_pass(
        _DTYPE_CODE[x.dtype], x.data_ptr(), out.data_ptr(), n, ilog2(tile),
        len(rounds), db, hi, lo, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "net_pass launch")
    LAUNCHES["net"] += 1
    return out


def cross_pass(x: torch.Tensor, span: int, tile: int, lo_bit: int,
               hi_bit: int, merge_only: bool, out=None) -> torch.Tensor:
    """K2, replacing ``icikit/ops/pallas_sort.py`` ``_cross_call``
    (pallas_call at :267): the cross-tile stages of one merge round
    whose Q-axis bits lie in [lo_bit, hi_bit], in one launch. ``out``
    may be ``x`` (in place).

    Bound: one read and one write of x, 2 * n * 4 bytes over the card's
    memory rate. CPU tensors take :func:`cross_pass_plain`."""
    n = x.shape[0]
    if (not is_pow2(span) or not is_pow2(tile) or n % span
            or not 0 <= lo_bit <= hi_bit
            or tile << (hi_bit + 1) > span):
        raise ValueError(f"cross_pass: bad geometry n={n} span={span} "
                         f"tile={tile} bits=[{lo_bit}, {hi_bit}]")
    if x.device.type == "cpu":
        res = cross_pass_plain(x, span, tile, lo_bit, hi_bit, merge_only)
        return res if out is None else out.copy_(res)
    out = _check_cuda(x, out, "cross_pass")
    g = hi_bit - lo_bit + 1
    if g > G_MAX_KERNEL:
        raise ValueError(f"cross_pass: {g} bits in one pass; the kernel "
                         f"takes at most {G_MAX_KERNEL}")
    if n % CROSS_ELEMS or x.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError(f"cross_pass: the kernel takes n a multiple of "
                         f"{CROSS_ELEMS} on 16-byte aligned buffers; got "
                         f"n={n}")
    lib = _build.load("bitonic_net")
    rc = lib.icikit_cross_pass(
        _DTYPE_CODE[x.dtype], x.data_ptr(), out.data_ptr(), n, span,
        ilog2(tile), lo_bit, hi_bit, ilog2(CROSS_ELEMS) - g, int(merge_only),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "cross_pass launch")
    LAUNCHES["cross"] += 1
    return out


# ---------------------------------------------------------------------------
# Drivers: a schedule of passes, run by the kernels or their plain versions.


def cross_ranges(bits: int, g_max: int):
    """The Q-axis bit ranges ``(lo, hi)`` of a merge round's ``bits``
    cross-tile stages, highest first: ``ceil(bits / g_max)`` passes
    whose widths differ by at most one (11 bits at g_max 10: 6 + 5). The
    reference's ``_build_sort`` fills each pass to g_max from the top
    (10 + 1); K2's 1-bit and 10-bit passes stream slowest. The stages,
    and so the output, are the same."""
    passes = -(-bits // g_max)
    base, extra = divmod(bits, passes)
    out, hi = [], bits - 1
    for i in range(passes):
        w = base + (i < extra)
        out.append((hi - w + 1, hi))
        hi -= w
    return out


def sort_schedule(n: int, t_grid: int = T_GRID, t_big: int = T_BIG,
                  g_max: int = G_MAX):
    """The passes of a full sort of n (power of two) elements:
    ``("net", tile, rounds)`` and ``("cross", span, tile, lo, hi,
    merge_only)`` (``_build_sort``, pallas_sort.py:304-347; the cross
    stages of a round split by :func:`cross_ranges`)."""
    log2n, log2t = ilog2(n), ilog2(t_grid)
    if n <= t_grid:
        return [("net", n, _sort_rounds(log2n))]
    plan = [("net", t_grid, _sort_rounds(log2t))]
    for i in range(log2t, log2n):
        span = 1 << (i + 1)
        if span <= t_big:
            plan.append(("net", span, _one_round(i)))
            continue
        for lo, hi in cross_ranges(i - log2t + 1, g_max):
            plan.append(("cross", span, t_grid, lo, hi, False))
        plan.append(("net", t_grid,
                     [(i + 1, tuple(1 << j for j in range(log2t - 1, -1,
                                                           -1)))]))
    return plan


def merge_schedule(n: int, t_grid: int = T_GRID, t_big: int = T_BIG,
                   g_max: int = G_MAX):
    """The passes that sort a bitonic span of n elements ascending
    (``_build_merge``, pallas_sort.py:350-368; the cross stages split by
    :func:`cross_ranges`)."""
    if n <= t_big:
        return [("net", n, _merge_rounds(n // 2))]
    plan = [("cross", n, t_grid, lo, hi, True)
            for lo, hi in cross_ranges(ilog2(n // t_grid), g_max)]
    plan.append(("net", t_grid, _merge_rounds(t_grid // 2)))
    return plan


def run_schedule(x: torch.Tensor, plan, plain: bool = False
                 ) -> torch.Tensor:
    """Run ``plan`` on flat ``x``. On the card the first pass writes a
    new buffer and the rest run in place on it, so a sort of n keys
    holds 2n keys of memory. ``plain`` runs the kernels' plain versions
    instead, on any device (to hold the kernels against them)."""
    cur = x
    for step in plan:
        if plain:
            cur = (net_pass_plain(cur, step[1], step[2]) if step[0] == "net"
                   else cross_pass_plain(cur, *step[1:]))
            continue
        dst = cur if (cur is not x and cur.is_cuda) else None
        if step[0] == "net":
            cur = net_pass(cur, step[1], step[2], out=dst)
        else:
            cur = cross_pass(cur, *step[1:], out=dst)
    return cur


def _resolve_backend(backend: str, dtype, n: int) -> str:
    if backend == "auto":
        return "kernel" if kernel_supported(dtype, n) else "torch"
    if backend not in ("kernel", "torch"):
        raise ValueError(f"unknown backend {backend!r}")
    return backend


def local_sort(x: torch.Tensor, backend: str = "auto", *,
               t_grid: int = T_GRID, t_big: int = T_BIG,
               g_max: int | None = None, plain: bool = False
               ) -> torch.Tensor:
    """Sort flat ``x`` ascending on its device; returns a new tensor.

    backend: 'auto' (the network for supported dtypes and sizes, else
    ``torch.sort``), 'kernel' (the network: CUDA kernels on a CUDA
    tensor, their plain versions on a CPU tensor), or 'torch'.
    ``plain`` runs the network's plain versions on any device.
    """
    n = x.shape[0]
    in_dtype = x.dtype
    half = in_dtype in (torch.bfloat16, torch.float16)
    usgn = in_dtype == torch.uint32
    kernel_dtype = (torch.float32 if half
                    else torch.int32 if usgn else in_dtype)
    backend = _resolve_backend(backend, kernel_dtype, n)
    if backend == "torch" or n < 2:
        return torch.sort(x).values
    if not kernel_supported(kernel_dtype, n):
        raise ValueError(
            f"kernel sort supports int32/uint32/float32 (bf16/f16 via "
            f"the f32 kernel) and n >= {MIN_KERNEL}; got {in_dtype} "
            f"n={n} (use backend='torch')")
    if half:
        x = x.to(torch.float32)
    if usgn:
        x = _u32_as_i32(x)
    x = x.contiguous()
    np2 = n if is_pow2(n) else 1 << n.bit_length()
    if np2 != n:
        x = torch.cat([x, torch.full((np2 - n,), sentinel_for(x.dtype),
                                     dtype=x.dtype, device=x.device)])
    out = run_schedule(x, sort_schedule(np2, t_grid, t_big,
                                        g_max or G_MAX), plain)
    out = out[:n] if np2 != n else out
    if usgn:
        return _i32_as_u32(out)
    return out.to(in_dtype) if half else out


def merge_bitonic(v: torch.Tensor, backend: str = "auto", *,
                  t_grid: int = T_GRID, t_big: int = T_BIG,
                  g_max: int | None = None, plain: bool = False
                  ) -> torch.Tensor:
    """Sort a *bitonic* power-of-2 vector ascending (the reference's
    compare-split completion step, psort.cc:121-137, as one fused merge
    network). A 2-D ``(rows, n)`` input merges each row independently,
    in the same launches: the passes treat the rows as independent
    spans of n. ``plain`` runs the plain versions on any device."""
    n = v.shape[-1]
    backend = _resolve_backend(backend, v.dtype, n)
    if backend == "torch":
        from icikit_torch.ops.merge import bitonic_merge
        return bitonic_merge(v, backend="torch")
    if not is_pow2(n):
        raise ValueError("merge_bitonic requires power-of-2 length")
    if not kernel_supported(v.dtype, n):
        raise ValueError(
            f"kernel merge supports int32/uint32/float32 and n >= "
            f"{MIN_KERNEL}; got {v.dtype} n={n} (use backend='torch')")
    shape = v.shape
    usgn = v.dtype == torch.uint32
    flat = v.reshape(-1)
    if usgn:
        flat = _u32_as_i32(flat)
    out = run_schedule(flat.contiguous(),
                       merge_schedule(n, t_grid, t_big, g_max or G_MAX),
                       plain)
    out = out.reshape(shape)
    return _i32_as_u32(out) if usgn else out


def sort_passes(n: int, t_grid: int = T_GRID, t_big: int = T_BIG,
                g_max: int = G_MAX) -> int:
    """Kernel launches (each one full read + write of the array) in a
    sort of n keys."""
    np2 = n if is_pow2(n) else 1 << n.bit_length()
    if np2 < MIN_KERNEL:
        return 0
    return len(sort_schedule(np2, t_grid, t_big, g_max))
