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


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def quant_matvec_plain(x: torch.Tensor, w8: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`quant_matvec`: float32 ``x @ w8^T``, then
    the per-channel scale (``quant_matvec_reference``'s order)."""
    return torch.matmul(x.float(), w8.float().t()) * scale.float()[None, :]


def quant_matvec(x: torch.Tensor, w8: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """``(x @ w8^T) * scale`` ``(rows, N)`` float32 from x ``(rows, K)``
    float32 or bf16, w8 ``(N, K)`` int8 and scale ``(N,)`` float32;
    K a multiple of 128 and N of 64 on a CUDA tensor.

    The kernel replaces ``icikit/ops/quant.py``'s ``_matvec_kernel``
    (B15, pallas_call at :167). Bound: the weight bytes at the decode
    step's 8 rows, the products at the prefill's 4096. It sums in
    another order than the plain version (bf16 products are exact on
    the tensor cores, float32 ones are FMAs), so the two agree to a
    tolerance, not bit for bit. CPU tensors take
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
    out = torch.empty((rows, n), dtype=torch.float32, device=x.device)
    lib = _build.load("quant")
    rc = lib.icikit_quant_matvec(
        _build.DTYPE_CODE[x.dtype], x.data_ptr(), w8.data_ptr(),
        scale.data_ptr(), out.data_ptr(), rows, n, k, _build.stream(x))
    _build.check(rc, "quant_matvec launch")
    LAUNCHES["quant_matvec"] += 1
    return out
