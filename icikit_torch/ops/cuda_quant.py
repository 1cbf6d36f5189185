"""The int8 matvec on Hopper: wrapper, launch count, plain version.

``quant_matvec`` (``csrc/quant.cu``) replaces ``icikit/ops/quant.py``'s
``_matvec_kernel`` (B15, pallas_call at :167): ``(x @ w8^T) * scale``
with float32 accumulation, the int8 weights streamed at one byte an
element. Beside it stands its plain version ``quant_matvec_plain``, a
float32 product and then the scale. The wrapper takes the plain version
only for a tensor on the CPU; for a CUDA tensor it launches the kernel
or raises. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

from icikit_torch.ops import _build

LAUNCHES = {"quant_matvec": 0}

# The bf16 kernel at rows <= SKINNY_ROWS (the decode step): a CTA a
# tile of SKINNY_CHANNELS output channels and a range of K's
# SKINNY_CHUNK-wide chunks, SKINNY_WARPS warps of at most SKINNY_CPW_MAX
# chunks each (SKINNY_CPW_MAX_NT2 at rows 9-16), all of a warp's loads in
# flight at once. K is split across CTAs only past that: on the card a
# split's in-launch merge (a fence, an atomic count, the last CTA's read
# back) cost more than the CTAs it added won, at every product of the
# int8 path (``PERF.md`` §6).
SKINNY_ROWS = 16
SKINNY_CHANNELS = 16
SKINNY_CHUNK = 64
SKINNY_WARPS = 8
SKINNY_CPW_MAX = 8
SKINNY_CPW_MAX_NT2 = 4
# The bf16 kernel past SKINNY_ROWS (the prefill): a CTA a tile of
# TILE_CHANNELS output channels (two wgmma warpgroups of 64) by 256 rows
# of x, K through a TMA ring. N must be a multiple of TILE_CHANNELS
# there, as JAX's gate asks (N tileable by 128).
TILE_CHANNELS = 128


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def skinny_chunks_max(rows: int) -> int:
    """K's 64-wide chunks one CTA of the skinny kernel takes at most."""
    return SKINNY_WARPS * (SKINNY_CPW_MAX if rows <= 8
                           else SKINNY_CPW_MAX_NT2)


def skinny_splits(rows: int, k: int) -> int:
    """The splits of K for the skinny kernel at ``rows`` rows and
    contraction ``k``: the fewest CTAs a channel tile that hold K's
    64-wide chunks (1 up to K 4096 at rows <= 8, 2048 at 9-16), the
    chunks shared out evenly, so no split is empty."""
    chunks = k // SKINNY_CHUNK
    return -(-chunks // skinny_chunks_max(rows))


def quant_matvec_plain(x: torch.Tensor, w8: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`quant_matvec`: float32 ``x @ w8^T``, then
    the per-channel scale (``quant_matvec_reference``'s order)."""
    return torch.matmul(x.float(), w8.float().t()) * scale.float()[None, :]


def quant_matvec(x: torch.Tensor, w8: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """``(x @ w8^T) * scale`` ``(rows, N)`` float32 from x ``(rows, K)``
    float32 or bf16, w8 ``(N, K)`` int8 and scale ``(N,)`` float32;
    K a multiple of 128 and N of 64 on a CUDA tensor (of 128 at bf16 and
    rows > 16).

    The kernel replaces ``icikit/ops/quant.py``'s ``_matvec_kernel``
    (B15, pallas_call at :167). Bound: the weight bytes at the decode
    step's 8 rows, the products at the prefill's 4096. At bf16 and
    rows <= 16 K is split across CTAs only past what one holds
    (:func:`skinny_splits`), the partials added in a fixed order in the
    same launch; past 16 rows a CTA takes a TILE_CHANNELS x 256-row
    tile on wgmma, the weights widened in registers. It
    sums in another order than the plain version (bf16 products are
    exact on the tensor cores, float32 ones are FMAs), so the two agree
    to a tolerance, not bit for bit. CPU tensors take
    :func:`quant_matvec_plain`."""
    rows, k = x.shape
    n = w8.shape[0]
    if w8.shape != (n, k) or scale.shape != (n,):
        raise ValueError(f"quant_matvec: x {tuple(x.shape)}, w8 "
                         f"{tuple(w8.shape)}, scale {tuple(scale.shape)} "
                         "disagree")
    if x.device.type == "cpu":
        return quant_matvec_plain(x, w8, scale)
    _build.check_operands("quant_matvec", (x,), x.dtype)
    for t, dt, name in ((w8, torch.int8, "w8"),
                        (scale, torch.float32, "scale")):
        if (t.device.type != "cuda" or t.dtype != dt
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"quant_matvec: {name} must be a contiguous, "
                             f"16-byte aligned CUDA {dt} tensor")
    if k % 128 or n % 64:
        raise ValueError(f"quant_matvec: k={k} must be a multiple of 128 "
                         f"and n={n} of 64")
    if x.dtype == torch.bfloat16 and rows > SKINNY_ROWS \
            and n % TILE_CHANNELS:
        raise ValueError(f"quant_matvec: the bf16 tile kernel (rows > "
                         f"{SKINNY_ROWS}) takes n a multiple of "
                         f"{TILE_CHANNELS}, got n={n}")
    out = torch.empty((rows, n), dtype=torch.float32, device=x.device)
    ws = counter = None
    splits = 1
    if x.dtype == torch.bfloat16 and rows <= SKINNY_ROWS:
        splits = skinny_splits(rows, k)
        if splits > 1:
            tiles = n // SKINNY_CHANNELS
            ws, counter = _build.split_scratch(
                x, "quant_matvec", tiles * splits * SKINNY_CHANNELS
                * SKINNY_ROWS, tiles)
    lib = _build.load("quant")
    rc = lib.icikit_quant_matvec_split(
        _build.DTYPE_CODE[x.dtype], x.data_ptr(), w8.data_ptr(),
        scale.data_ptr(), out.data_ptr(), rows, n, k,
        None if ws is None else ws.data_ptr(),
        None if counter is None else counter.data_ptr(), splits,
        _build.stream(x))
    if rc and counter is not None:  # counters may be part-way: zero them
        counter.zero_()
    _build.check(rc, "quant_matvec launch")
    LAUNCHES["quant_matvec"] += 1
    return out
