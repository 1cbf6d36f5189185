"""Attention kernels on Hopper: wrappers, launch counts, plain versions.

Two CUDA kernels (``csrc/attention.cu``) carry the greedy decode path:

- ``flash_fwd`` replaces ``icikit/ops/flash_attention.py``'s
  ``_fwd_kernel`` (B3, ``_fwd_call``) and ``_fwd_single_kernel`` (B5,
  ``_fwd_single_call``): the causal or full forward, out and lse.
- ``decode_step`` replaces ``_decode_step_kernel`` (B13,
  ``decode_step_attention``): RoPE, the cache column write in place and
  the masked single-token attention.

Beside each kernel stands its plain PyTorch version (``flash_fwd_plain``,
``decode_step_plain``), the same function as whole-tensor ops. A wrapper
takes the plain version only for a tensor on the CPU; for a CUDA tensor
it launches the kernel or raises. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

from icikit_torch.ops import _build
from icikit_torch.ops.attention import NEG_INF
from icikit_torch.ops.common import LN2, LOG2E

LAUNCHES = {"flash_fwd": 0, "decode_step": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
FLASH_HEAD_DIMS = (64, 128)
DECODE_HEAD_DIMS = (128, 256)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Plain versions: whole-tensor ops, any device.


def flash_fwd_plain(qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor,
                    causal: bool, scale: float):
    """Plain version of ``flash_fwd`` on ``(b, h, s, d)`` tensors: the
    one-block form of the TPU forward (``_fwd_single_kernel``): base-2
    logits with log2(e) folded into the scale, a direct row max and sum,
    P cast to the value dtype before PV, division by l at the end.
    Returns ``(out (b, h, s_q, d) in q's dtype, lse (b, h, s_q) f32)``."""
    s = torch.matmul(qt.float(), kt.float().transpose(-1, -2)) \
        * (scale * LOG2E)
    if causal:
        sq, sk = qt.shape[2], kt.shape[2]
        keep = (torch.arange(sq, device=qt.device)[:, None]
                >= torch.arange(sk, device=qt.device)[None, :])
        s = torch.where(keep, s, torch.tensor(NEG_INF, device=qt.device))
    m = s.amax(dim=-1, keepdim=True)
    w = torch.exp2(s - m)
    l = w.sum(dim=-1, keepdim=True)
    acc = torch.matmul(w.to(vt.dtype).float(), vt.float())
    out = (acc / l).to(qt.dtype)
    lse = m[..., 0] * LN2 + torch.log(l[..., 0])
    return out, lse


def _rotate(x: torch.Tensor, cos2: torch.Tensor, sin2: torch.Tensor
            ) -> torch.Tensor:
    """Split-half RoPE of ``(rows, dh)`` from the duplicated tables
    ``cos2 = [c, c]``, ``sin2 = [s, s]`` ``(1, dh)``: the TPU kernel's
    ``x * cos2 + rot * sin2`` (rot = [-x2, x1]) with the first product
    fused into the add, as XLA compiles it and as the CUDA kernel's
    ``fmaf`` computes it. The fused product is exact in float64, so one
    float64 add and a rounding to float32 give the same bits (a double
    rounding could differ in a tie far rarer than one element in 2^28).
    """
    h = x.shape[-1] // 2
    x32 = x.float()
    rot = torch.cat([-x32[:, h:], x32[:, :h]], dim=-1)
    return (x32.double() * cos2.double()
            + (rot * sin2).double()).float()


def decode_step_plain(q, k, v, kcache, vcache, cur: int, cos2, sin2, *,
                      scale: float, rope: bool) -> torch.Tensor:
    """Plain version of ``decode_step``: q, k, v ``(rows, dh)``, caches
    ``(rows, total, dh)``. Writes the (rotated) k and v at column
    ``cur`` of the caches in place and returns the attention of q over
    columns ``<= cur`` ``(rows, dh)``, in the order of
    ``_decode_step_kernel``: q and k rotated in float32 and rounded to
    their dtype, logits with natural exp over the past columns read
    from the cache plus the ``cur`` term from the fresh k, past weights
    cast to the cache dtype before the value product."""
    if rope:
        q = _rotate(q, cos2, sin2).to(q.dtype)
        k = _rotate(k, cos2, sin2).to(k.dtype)
    kcache[:, cur] = k.to(kcache.dtype)
    vcache[:, cur] = v.to(vcache.dtype)
    qf = q.float()
    past = torch.einsum("rd,rtd->rt", qf, kcache[:, :cur].float()) * scale
    now = (qf * k.float()).sum(dim=-1, keepdim=True) * scale
    logits = torch.cat([past, now], dim=-1)
    m = logits.amax(dim=-1, keepdim=True)
    w = torch.exp(logits - m)
    l = w.sum(dim=-1, keepdim=True)
    acc = torch.einsum("rt,rtd->rd", w[:, :cur].to(vcache.dtype).float(),
                       vcache[:, :cur].float())
    acc = acc + w[:, cur:] * v.float()
    return (acc / l).to(q.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers.


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _check_cuda(what: str, tensors, dtype) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{what}: expected CUDA or CPU tensors, got "
                             f"{t.device}")
        if t.dtype != dtype:
            raise ValueError(f"{what}: every operand must be {dtype}, got "
                             f"{t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: operands must be contiguous and "
                             f"16-byte aligned")
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"{what}: the kernel takes float32 or bfloat16, "
                         f"got {dtype}")


def flash_fwd(qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor,
              causal: bool, scale: float):
    """Flash-attention forward on ``(b, h, s, d)`` tensors; returns
    ``(out (b, h, s_q, d), lse (b, h, s_q) float32, nats)``.

    The kernel replaces ``icikit/ops/flash_attention.py``'s
    ``_fwd_kernel`` (B3, pallas_call at :421) and ``_fwd_single_kernel``
    (B5, :349). Bound: one read of q, k, v and one write of out and lse
    over the card's memory rate (bytes, at the decode prefill's shapes).
    CPU tensors take :func:`flash_fwd_plain`."""
    b, h, sq, d = qt.shape
    sk = kt.shape[2]
    if kt.shape != (b, h, sk, d) or vt.shape != kt.shape:
        raise ValueError(f"flash_fwd: shapes {tuple(qt.shape)}, "
                         f"{tuple(kt.shape)}, {tuple(vt.shape)} disagree")
    if causal and sq != sk:
        raise ValueError("flash_fwd: causal needs s_q == s_kv")
    if qt.device.type == "cpu":
        return flash_fwd_plain(qt, kt, vt, causal, scale)
    _check_cuda("flash_fwd", (qt, kt, vt), qt.dtype)
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash_fwd: head dim {d} not in the kernel's "
                         f"{FLASH_HEAD_DIMS}")
    out = torch.empty_like(qt)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=qt.device)
    lib = _build.load("attention")
    rc = lib.icikit_flash_fwd(
        _DTYPE_CODE[qt.dtype], qt.data_ptr(), kt.data_ptr(), vt.data_ptr(),
        out.data_ptr(), lse.data_ptr(), b * h, sq, sk, d, int(causal),
        float(scale) * LOG2E, _stream(qt))
    _build.check(rc, "flash_fwd launch")
    LAUNCHES["flash_fwd"] += 1
    return out, lse


def decode_step(q, k, v, kcache, vcache, cur: int, cos2, sin2, *,
                scale: float, rope: bool) -> torch.Tensor:
    """One decode step of attention for ``rows = b * h`` rows: q, k, v
    ``(rows, dh)``, caches ``(rows, total, dh)`` updated at column
    ``cur`` in place, ``cos2``/``sin2`` the duplicated RoPE tables
    ``(1, dh)`` float32. Returns the attention ``(rows, dh)``.

    The kernel replaces ``icikit/ops/flash_attention.py``'s
    ``_decode_step_kernel`` (B13, pallas_call at :1120). Bound: reading
    the ``cur`` past columns of K and V (bytes). CPU tensors take
    :func:`decode_step_plain`."""
    rows, dh = q.shape
    total = kcache.shape[1]
    if (k.shape != q.shape or v.shape != q.shape
            or kcache.shape != (rows, total, dh)
            or vcache.shape != kcache.shape):
        raise ValueError("decode_step: q/k/v must be (rows, dh) and the "
                         "caches (rows, total, dh)")
    if not 0 <= cur < total:
        raise ValueError(f"decode_step: cur={cur} outside [0, {total})")
    if q.device.type == "cpu":
        return decode_step_plain(q, k, v, kcache, vcache, cur, cos2, sin2,
                                 scale=scale, rope=rope)
    _check_cuda("decode_step", (q, k, v, kcache, vcache), q.dtype)
    _check_cuda("decode_step tables", (cos2, sin2), torch.float32)
    if dh not in DECODE_HEAD_DIMS or cos2.numel() != dh \
            or sin2.numel() != dh:
        raise ValueError(f"decode_step: head dim {dh} not in the kernel's "
                         f"{DECODE_HEAD_DIMS}, or tables not ({dh},)")
    out = torch.empty_like(q)
    lib = _build.load("attention")
    rc = lib.icikit_decode_step(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        cos2.data_ptr(), sin2.data_ptr(), kcache.data_ptr(),
        vcache.data_ptr(), out.data_ptr(), rows, total, dh, int(cur),
        int(rope), float(scale), _stream(q))
    _build.check(rc, "decode_step launch")
    LAUNCHES["decode_step"] += 1
    return out
