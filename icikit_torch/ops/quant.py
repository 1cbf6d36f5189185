"""Per-channel symmetric quantization and the int8 matvec.

The port of ``icikit/ops/quant.py``. Every quantized tensor stores its
contraction axis last, so one convention covers weights and the KV
cache: ``scale = max|x| / qmax`` over the last axis, ``q = round(x /
scale)`` clipped to ``[-qmax, qmax]``. The scheme is symmetric, so the
dequant is one multiply that folds out of a product: ``x @ dequant(q,
s)`` per output channel is ``(x @ q) * s``, and the int8 operand feeds
the product directly. Channels that are all zero store ``scale = 0``
and dequantize to exact zeros; the divisor is made safe separately.

``quant_matvec`` is the int8 matvec ``(x @ w8^T) * scale`` with float32
accumulation: on a CUDA tensor the kernel ``cuda_quant.quant_matvec``
(the counterpart of the TPU's ``_matvec_kernel``, B15), on a CPU tensor
its plain version. ``qmm`` is the model-facing form with any leading
and contraction dims.
"""

from __future__ import annotations

import torch

from icikit_torch.ops import cuda_quant

# name -> (storage dtype, symmetric max), as in JAX. Only int8 is wired
# through the model configs; the fp8 rows quantize and dequantize.
QDTYPES = {
    "int8": (torch.int8, 127.0),
    "fp8_e4m3": (torch.float8_e4m3fn, 448.0),
    "fp8_e5m2": (torch.float8_e5m2, 57344.0),
}

QMM_IMPLS = ("auto", "pallas", "xla")


def _qdtype(name: str):
    if name not in QDTYPES:
        raise ValueError(f"unknown quant dtype {name!r} "
                         f"(known: {', '.join(sorted(QDTYPES))})")
    return QDTYPES[name]


def quantize_last(x: torch.Tensor, qdtype: str = "int8"):
    """Per-channel symmetric quantization over the last axis: ``(q,
    scale)`` with ``q`` of ``x.shape`` in the storage dtype and
    ``scale`` float32 of ``x.shape[:-1]``. JAX's float32 arithmetic:
    ``amax / qmax``, the divisor 1 where the scale vanishes, clip, then
    round half to even for int8 or the storage cast (round to nearest
    even) for fp8."""
    dt, qmax = _qdtype(qdtype)
    x32 = x.float()
    amax = x32.abs().amax(dim=-1)
    scale = amax / qmax
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))[..., None]
    scaled = torch.clamp(x32 / safe, -qmax, qmax)
    if not dt.is_floating_point:
        scaled = torch.round(scaled)
    return scaled.to(dt), scale


def dequantize_last(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_last`: float32 ``q * scale`` with the
    scale broadcast over the last axis."""
    return q.float() * scale.float()[..., None]


def _pick_n_block(n: int) -> int | None:
    for bn in (512, 256, 128):
        if n % bn == 0:
            return bn
    return None


def quant_matvec_supported(rows: int, n: int, k: int,
                           device="cuda") -> bool:
    """JAX's gate of the int8 matvec: a contraction dim that is a
    multiple of 128, an output-channel count tileable by 512, 256 or
    128, on a device with the kernel (``cuda``) or its plain version
    (``cpu``). Callers check first; forcing the kernel off the gate
    raises."""
    if k % 128 or k < 128:
        return False
    if _pick_n_block(n) is None:
        return False
    return torch.device(device).type in ("cuda", "cpu")


def quant_matvec(x: torch.Tensor, w8: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """``(x @ w8^T) * scale``, float32 out: x ``(rows, K)`` float32 or
    bf16, w8 ``(N, K)`` int8 with the contraction last, scale ``(N,)``
    float32. The kernel on a CUDA tensor, its plain version on a CPU
    tensor; raises off :func:`quant_matvec_supported`."""
    rows, k = x.shape
    n = w8.shape[0]
    if not quant_matvec_supported(rows, n, k, x.device):
        raise ValueError(
            f"quant_matvec unsupported for rows={rows}, n={n}, k={k} "
            f"on {x.device} (need k % 128 == 0 and n tileable by 128) — "
            "gate with quant_matvec_supported")
    return cuda_quant.quant_matvec(x, w8, scale)


def quant_matvec_reference(x: torch.Tensor, w8: torch.Tensor,
                           scale: torch.Tensor) -> torch.Tensor:
    """The reference dequant product: float32 ``x @ w8^T`` scaled per
    channel (the kernel's plain version)."""
    return cuda_quant.quant_matvec_plain(x, w8, scale)


def qmm(x: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor,
        k_ndim: int = 1, impl: str = "auto") -> torch.Tensor:
    """Quantized product with any leading and output dims, float32 out.

    ``x (..., K1..Kk)`` against ``w8 (out..., K1..Kk)`` whose last
    ``k_ndim`` axes are the contraction; ``scale (out...)``. Returns
    ``(..., out...)``. ``impl``: ``"pallas"`` forces the kernel route
    (:func:`quant_matvec`; raises off the gate), ``"xla"`` JAX's plain
    formulation (a float32 product, then the scale), ``"auto"`` the
    kernel on a CUDA device when the gate accepts the flattened shape
    and the plain formulation otherwise, as JAX's ``"auto"`` takes the
    kernel on the TPU."""
    if impl not in QMM_IMPLS:
        raise ValueError(f"unknown quant impl {impl!r} "
                         f"(known: {', '.join(QMM_IMPLS)})")
    bshape = x.shape[:x.dim() - k_ndim]
    kshape = x.shape[x.dim() - k_ndim:]
    oshape = w8.shape[:w8.dim() - k_ndim]
    if tuple(w8.shape[w8.dim() - k_ndim:]) != tuple(kshape):
        raise ValueError(f"contraction mismatch: x {tuple(x.shape)} vs "
                         f"w8 {tuple(w8.shape)} (k_ndim={k_ndim})")
    rows, k, n = bshape.numel(), kshape.numel(), oshape.numel()
    x2, w2, s2 = x.reshape(rows, k), w8.reshape(n, k), scale.reshape(n)
    use_kernel = impl == "pallas" or (
        impl == "auto" and x.device.type == "cuda"
        and quant_matvec_supported(rows, n, k, x.device))
    out = (quant_matvec(x2.contiguous(), w2, s2) if use_kernel
           else quant_matvec_reference(x2, w2, s2))
    return out.reshape(*bshape, *oshape)
