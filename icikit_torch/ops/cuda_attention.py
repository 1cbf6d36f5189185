"""Attention kernels on Hopper: wrappers, launch counts, plain versions.

Three CUDA kernels (``csrc/attention.cu``) carry the decode and train
paths:

- ``flash_fwd`` replaces ``icikit/ops/flash_attention.py``'s
  ``_fwd_kernel`` (B3, ``_fwd_call``), ``_fwd_const_kernel`` (B4, the
  constant-shift forward) and ``_fwd_single_kernel`` (B5,
  ``_fwd_single_call``): the causal or full forward, out and lse,
  online or with a constant shift.
- ``flash_bwd`` replaces ``_bwd_fused_kernel`` (B6, ``_bwd_call``) and
  ``_bwd_fused_tiled_kernel`` (B7): dq, dk and dv from one
  recomputation of P per tile.
- ``decode_step`` replaces ``_decode_step_kernel`` (B13,
  ``decode_step_attention``): RoPE, the cache column write in place and
  the masked single-token attention.

Beside each kernel stands its plain PyTorch version (``flash_fwd_plain``,
``flash_bwd_plain``, ``decode_step_plain``), the same function as
whole-tensor ops. A wrapper takes the plain version only for a tensor on
the CPU; for a CUDA tensor it launches the kernel or raises.
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

from icikit_torch.ops import _build
from icikit_torch.ops.attention import NEG_INF
from icikit_torch.ops.common import LN2, LOG2E

LAUNCHES = {"flash_fwd": 0, "flash_bwd": 0, "decode_step": 0}

# d_head 32 is the tiny preset's; 64 and 128 the TPU-shaped presets'.
FLASH_HEAD_DIMS = (32, 64, 128)
# The constant-shift forward keeps a row whose shifted sum l lies in this
# range and redoes it online otherwise (the kernel's SUM_LO, SUM_HI).
SHIFT_SUM_RANGE = (2.0 ** -64, 2.0 ** 64)
DECODE_HEAD_DIMS = (128, 256)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Plain versions: whole-tensor ops, any device.


def _scaled_logits(qt, kt, causal: bool, scale: float) -> torch.Tensor:
    """float32 base-2 logits ``q k^T * scale * log2(e)`` with the causal
    mask's finite NEG_INF, ``(b, h, s_q, s_kv)``."""
    s = torch.matmul(qt.float(), kt.float().transpose(-1, -2)) \
        * (scale * LOG2E)
    if causal:
        sq, sk = qt.shape[2], kt.shape[2]
        keep = (torch.arange(sq, device=qt.device)[:, None]
                >= torch.arange(sk, device=qt.device)[None, :])
        s = torch.where(keep, s, torch.tensor(NEG_INF, device=qt.device))
    return s


def flash_fwd_plain(qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor,
                    causal: bool, scale: float, shift: float | None = None):
    """Plain version of ``flash_fwd`` on ``(b, h, s, d)`` tensors: the
    one-block form of the TPU forward (``_fwd_single_kernel``): base-2
    logits with log2(e) folded into the scale, a direct row max and sum
    (or the constant ``shift`` in its place), P cast to the value dtype
    before PV, division by l at the end. With ``shift``, a row whose
    shifted sum l leaves ``SHIFT_SUM_RANGE`` (overflow, total underflow,
    or weights in exp2's subnormal range) takes the online values: the
    exact fallback, row by row (the kernel redoes the whole 64-row tile
    of such a row; the other rows of that tile then differ from this
    version by rounding). Returns ``(out (b, h, s_q, d) in q's dtype,
    lse (b, h, s_q) f32)``."""
    s = _scaled_logits(qt, kt, causal, scale)

    def finish(m):
        w = torch.exp2(s - m)
        l = w.sum(dim=-1, keepdim=True)
        acc = torch.matmul(w.to(vt.dtype).float(), vt.float())
        return ((acc / l).to(qt.dtype),
                m[..., 0] * LN2 + torch.log(l[..., 0]), l[..., 0])

    out, lse, _ = finish(s.amax(dim=-1, keepdim=True))
    if shift is None:
        return out, lse
    s_out, s_lse, s_l = finish(torch.full_like(s[..., :1], float(shift)))
    lo, hi = SHIFT_SUM_RANGE
    ok = (s_l >= lo) & (s_l <= hi)
    return (torch.where(ok[..., None], s_out, out),
            torch.where(ok, s_lse, lse))


def flash_bwd_plain(qt, kt, vt, do, lse, delta, causal: bool,
                    scale: float):
    """Plain version of ``flash_bwd`` on ``(b, h, s, d)`` tensors, in the
    order of the TPU's ``_bwd_fused_kernel``: P recomputed in base 2
    from lse (``_p_tile``), dv = P^T dO with P cast to dO's dtype, dS =
    P (dP - delta) scale, dq = dS K and dk = dS^T Q with dS cast to the
    operands' dtype. ``delta`` is rowsum(dO o O) - g_lse ``(b, h, s_q)``
    float32. Returns ``(dq, dk, dv)`` in q's, k's and v's dtypes."""
    s = _scaled_logits(qt, kt, causal, scale)
    p = torch.exp2(s - (lse * LOG2E)[..., None])
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dp = torch.matmul(do.float(), vt.float().transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.matmul(ds.to(kt.dtype).float(), kt.float())
    dk = torch.matmul(ds.to(qt.dtype).float().transpose(-1, -2), qt.float())
    return dq.to(qt.dtype), dk.to(kt.dtype), dv.to(vt.dtype)


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


def _check_flash_shapes(what, qt, kt, vt, causal):
    b, h, sq, d = qt.shape
    sk = kt.shape[2]
    if kt.shape != (b, h, sk, d) or vt.shape != kt.shape:
        raise ValueError(f"{what}: shapes {tuple(qt.shape)}, "
                         f"{tuple(kt.shape)}, {tuple(vt.shape)} disagree")
    if causal and sq != sk:
        raise ValueError(f"{what}: causal needs s_q == s_kv")


def _check_head_dim(what, d):
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"{what}: head dim {d} not in the kernel's "
                         f"{FLASH_HEAD_DIMS}")


def flash_fwd(qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor,
              causal: bool, scale: float, shift: float | None = None):
    """Flash-attention forward on ``(b, h, s, d)`` tensors; returns
    ``(out (b, h, s_q, d), lse (b, h, s_q) float32, nats)``. ``shift``
    (base 2) selects the constant-shift mode, whose overflowing tiles
    the kernel redoes online itself.

    The kernel replaces ``icikit/ops/flash_attention.py``'s
    ``_fwd_kernel`` (B3, pallas_call at :421), ``_fwd_const_kernel``
    (B4) and ``_fwd_single_kernel`` (B5, :349). Bound: one read of q, k,
    v and one write of out and lse over the card's memory rate (bytes,
    at the decode prefill's and the train step's shapes). CPU tensors
    take :func:`flash_fwd_plain`."""
    _check_flash_shapes("flash_fwd", qt, kt, vt, causal)
    b, h, sq, d = qt.shape
    sk = kt.shape[2]
    if qt.device.type == "cpu":
        return flash_fwd_plain(qt, kt, vt, causal, scale, shift)
    _build.check_operands("flash_fwd", (qt, kt, vt), qt.dtype)
    _check_head_dim("flash_fwd", d)
    out = torch.empty_like(qt)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=qt.device)
    lib = _build.load("attention")
    rc = lib.icikit_flash_fwd(
        _build.DTYPE_CODE[qt.dtype], qt.data_ptr(), kt.data_ptr(),
        vt.data_ptr(), out.data_ptr(), lse.data_ptr(), b * h, sq, sk, d, int(causal),
        float(scale) * LOG2E, int(shift is not None),
        0.0 if shift is None else float(shift), _build.stream(qt))
    _build.check(rc, "flash_fwd launch")
    LAUNCHES["flash_fwd"] += 1
    return out, lse


def flash_bwd(qt, kt, vt, do, lse, delta, causal: bool, scale: float):
    """Flash-attention backward on ``(b, h, s, d)`` tensors: ``do`` is
    the output cotangent, ``lse`` the forward's, ``delta`` rowsum(dO o
    O) - g_lse ``(b, h, s_q)`` float32. Returns ``(dq, dk, dv)``.

    The kernel replaces ``icikit/ops/flash_attention.py``'s
    ``_bwd_fused_kernel`` (B6, pallas_call at :701) and
    ``_bwd_fused_tiled_kernel`` (B7, :653). dq is summed across CTAs
    with float32 atomics, so its last bits vary from run to run. Bound:
    five causal products over the card's bf16 rate (operations, at the
    train step's shapes). CPU tensors take :func:`flash_bwd_plain`."""
    _check_flash_shapes("flash_bwd", qt, kt, vt, causal)
    b, h, sq, d = qt.shape
    sk = kt.shape[2]
    if do.shape != qt.shape or lse.shape != (b, h, sq) \
            or delta.shape != lse.shape:
        raise ValueError(f"flash_bwd: do {tuple(do.shape)}, lse "
                         f"{tuple(lse.shape)}, delta {tuple(delta.shape)} "
                         f"do not fit q {tuple(qt.shape)}")
    if qt.device.type == "cpu":
        return flash_bwd_plain(qt, kt, vt, do, lse, delta, causal, scale)
    _build.check_operands("flash_bwd", (qt, kt, vt, do), qt.dtype)
    _build.check_operands("flash_bwd statistics", (lse, delta), torch.float32)
    _check_head_dim("flash_bwd", d)
    dq = torch.zeros((b, h, sq, d), dtype=torch.float32, device=qt.device)
    dk = torch.empty_like(kt)
    dv = torch.empty_like(vt)
    lib = _build.load("attention")
    rc = lib.icikit_flash_bwd(
        _build.DTYPE_CODE[qt.dtype], qt.data_ptr(), kt.data_ptr(),
        vt.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b * h, sq, sk, d, int(causal),
        float(scale) * LOG2E, float(scale), _build.stream(qt))
    _build.check(rc, "flash_bwd launch")
    LAUNCHES["flash_bwd"] += 1
    return dq.to(qt.dtype), dk, dv


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
    _build.check_operands("decode_step", (q, k, v, kcache, vcache), q.dtype)
    _build.check_operands("decode_step tables", (cos2, sin2), torch.float32)
    if dh not in DECODE_HEAD_DIMS or cos2.numel() != dh \
            or sin2.numel() != dh:
        raise ValueError(f"decode_step: head dim {dh} not in the kernel's "
                         f"{DECODE_HEAD_DIMS}, or tables not ({dh},)")
    out = torch.empty_like(q)
    lib = _build.load("attention")
    rc = lib.icikit_decode_step(
        _build.DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        cos2.data_ptr(), sin2.data_ptr(), kcache.data_ptr(),
        vcache.data_ptr(), out.data_ptr(), rows, total, dh, int(cur),
        int(rope), float(scale), _build.stream(q))
    _build.check(rc, "decode_step launch")
    LAUNCHES["decode_step"] += 1
    return out
