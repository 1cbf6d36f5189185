"""Attention kernels on Hopper: wrappers, launch counts, plain versions.

The CUDA kernels of ``csrc/attention.cu`` carry the decode and train
paths:

- ``flash_fwd`` replaces ``icikit/ops/flash_attention.py``'s
  ``_fwd_kernel`` (B3, ``_fwd_call``), ``_fwd_const_kernel`` (B4, the
  constant-shift forward) and ``_fwd_single_kernel`` (B5,
  ``_fwd_single_call``): the causal or full forward, out and lse,
  online or with a constant shift.
- ``flash_bwd`` replaces ``_bwd_fused_kernel`` (B6, ``_bwd_call``) and
  ``_bwd_fused_tiled_kernel`` (B7): dq, dk and dv from one
  recomputation of P per tile.
- ``flash_bwd_dq`` and ``flash_bwd_dkv`` replace ``_bwd_dq_kernel`` and
  ``_bwd_dkv_kernel`` (B8, ``_bwd_call`` past the dq scratch budget):
  the deterministic two-pass backward, each output written once.
- ``decode_step`` replaces ``_decode_step_kernel`` (B13,
  ``decode_step_attention``): RoPE, the cache column write in place and
  the masked single-token attention.
- ``decode_step_q8`` replaces ``_decode_step_q8_kernel`` (B14,
  ``decode_step_attention_q8``): the same step over int8 caches with
  per-column float32 scales folded into the logits and the weights.

Beside each kernel stands its plain PyTorch version (``flash_fwd_plain``,
``flash_bwd_plain``, ``flash_bwd_dq_plain``, ``flash_bwd_dkv_plain``,
``decode_step_plain``, ``decode_step_q8_plain``), the same function as
whole-tensor ops; the flash ones take ``chunk`` to walk the Q rows a
chunk at a time, so that a long sequence's logits never exist whole
(131072 keys: 2 GB for a 1024-row chunk of 4 heads, where the whole
matrix would take 275 GB). A wrapper takes the plain version only for a
tensor on the CPU; for a CUDA tensor it launches the kernel or raises.
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

from icikit_torch.ops import _build
from icikit_torch.ops.attention import NEG_INF
from icikit_torch.ops.common import LN2, LOG2E

LAUNCHES = {"flash_fwd": 0, "flash_bwd": 0, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0, "decode_step": 0, "decode_step_q8": 0}

# d_head 32 is the tiny preset's; 64 and 128 the TPU-shaped presets';
# 256 the widest head the decode gate's configs train and prefill with.
FLASH_HEAD_DIMS = (32, 64, 128, 256)
# The constant-shift forward keeps a row whose shifted sum l lies in this
# range and redoes it online otherwise (the kernel's SUM_LO, SUM_HI).
SHIFT_SUM_RANGE = (2.0 ** -64, 2.0 ** 64)
# The decode steps walk a row in chunks of this many elements, so they
# take any head dim that is a positive multiple of it (JAX's gate).
DECODE_CHUNK = 128


def decode_head_dim_ok(dh: int) -> bool:
    """Does the fused decode step (B13, B14) take head dim ``dh``?"""
    return dh >= DECODE_CHUNK and dh % DECODE_CHUNK == 0


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Plain versions: whole-tensor ops, any device.


def _scaled_logits(qt, kt, causal: bool, scale: float,
                   q0: int = 0) -> torch.Tensor:
    """float32 base-2 logits ``q k^T * scale * log2(e)`` with the causal
    mask's finite NEG_INF, ``(b, h, s_q, s_kv)``; ``q0`` is the position
    of q's first row (a chunk of a longer sequence)."""
    s = torch.matmul(qt.float(), kt.float().transpose(-1, -2)) \
        * (scale * LOG2E)
    if causal:
        sq, sk = qt.shape[2], kt.shape[2]
        keep = (torch.arange(q0, q0 + sq, device=qt.device)[:, None]
                >= torch.arange(sk, device=qt.device)[None, :])
        s = torch.where(keep, s, torch.tensor(NEG_INF, device=qt.device))
    return s


def _row_chunks(sq: int, sk: int, causal: bool, chunk: int | None):
    """(first row, end row, end key) of each Q-row chunk: a causal chunk
    needs only the keys up to its last row, the rest are masked to an
    exact 0 in P."""
    step = sq if chunk is None else chunk
    for r0 in range(0, sq, step):
        r1 = min(r0 + step, sq)
        yield r0, r1, (r1 if causal else sk)


def _fwd_rows(qt, kt, vt, causal, scale, shift, q0):
    s = _scaled_logits(qt, kt, causal, scale, q0)

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


def flash_fwd_plain(qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor,
                    causal: bool, scale: float, shift: float | None = None,
                    chunk: int | None = None):
    """Plain version of ``flash_fwd`` on ``(b, h, s, d)`` tensors: the
    one-block form of the TPU forward (``_fwd_single_kernel``): base-2
    logits with log2(e) folded into the scale, a direct row max and sum
    (or the constant ``shift`` in its place), P cast to the value dtype
    before PV, division by l at the end. With ``shift``, a row whose
    shifted sum l leaves ``SHIFT_SUM_RANGE`` (overflow, total underflow,
    or weights in exp2's subnormal range) takes the online values: the
    exact fallback, row by row (the kernel redoes the whole 64-row tile
    of such a row; the other rows of that tile then differ from this
    version by rounding). ``chunk``: Q rows a step (None: all). Returns
    ``(out (b, h, s_q, d) in q's dtype, lse (b, h, s_q) f32)``."""
    sk = kt.shape[2]
    parts = [_fwd_rows(qt[:, :, r0:r1], kt[:, :, :k1], vt[:, :, :k1],
                       causal, scale, shift, r0)
             for r0, r1, k1 in _row_chunks(qt.shape[2], sk, causal, chunk)]
    if len(parts) == 1:
        return parts[0]
    return (torch.cat([o for o, _ in parts], dim=2),
            torch.cat([l for _, l in parts], dim=2))


def _bwd_plain(qt, kt, vt, do, lse, delta, causal, scale, chunk,
               want_dq: bool, want_dkv: bool):
    """The backward's arithmetic, Q-row chunk by chunk: dq, dk, dv (None
    where not wanted). dk and dv sum over the chunks in float32."""
    b, h, sq, d = qt.shape
    sk = kt.shape[2]
    dqs = []
    if want_dkv:
        dk = torch.zeros((b, h, sk, d), dtype=torch.float32,
                         device=qt.device)
        dv = torch.zeros_like(dk)
    for r0, r1, k1 in _row_chunks(sq, sk, causal, chunk):
        q_, do_ = qt[:, :, r0:r1], do[:, :, r0:r1]
        k_, v_ = kt[:, :, :k1], vt[:, :, :k1]
        s = _scaled_logits(q_, k_, causal, scale, r0)
        p = torch.exp2(s - (lse[..., r0:r1] * LOG2E)[..., None])
        dp = torch.matmul(do_.float(), v_.float().transpose(-1, -2))
        ds = p * (dp - delta[..., r0:r1, None]) * scale
        if want_dq:
            dqs.append(torch.matmul(ds.to(kt.dtype).float(), k_.float()))
        if want_dkv:
            dv[:, :, :k1] += torch.matmul(
                p.to(do.dtype).float().transpose(-1, -2), do_.float())
            dk[:, :, :k1] += torch.matmul(
                ds.to(qt.dtype).float().transpose(-1, -2), q_.float())
        del s, p, dp, ds
    return (torch.cat(dqs, dim=2).to(qt.dtype) if want_dq else None,
            dk.to(kt.dtype) if want_dkv else None,
            dv.to(vt.dtype) if want_dkv else None)


def flash_bwd_plain(qt, kt, vt, do, lse, delta, causal: bool,
                    scale: float, chunk: int | None = None):
    """Plain version of ``flash_bwd`` on ``(b, h, s, d)`` tensors, in the
    order of the TPU's ``_bwd_fused_kernel``: P recomputed in base 2
    from lse (``_p_tile``), dv = P^T dO with P cast to dO's dtype, dS =
    P (dP - delta) scale, dq = dS K and dk = dS^T Q with dS cast to the
    operands' dtype. ``delta`` is rowsum(dO o O) - g_lse ``(b, h, s_q)``
    float32. ``chunk``: Q rows a step (None: all). Returns ``(dq, dk,
    dv)`` in q's, k's and v's dtypes."""
    return _bwd_plain(qt, kt, vt, do, lse, delta, causal, scale, chunk,
                      True, True)


def flash_bwd_dq_plain(qt, kt, vt, do, lse, delta, causal: bool,
                       scale: float, chunk: int | None = None):
    """Plain version of ``flash_bwd_dq`` (``_bwd_dq_kernel``): dq alone,
    by the arithmetic of :func:`flash_bwd_plain`."""
    return _bwd_plain(qt, kt, vt, do, lse, delta, causal, scale, chunk,
                      True, False)[0]


def flash_bwd_dkv_plain(qt, kt, vt, do, lse, delta, causal: bool,
                        scale: float, chunk: int | None = None):
    """Plain version of ``flash_bwd_dkv`` (``_bwd_dkv_kernel``): ``(dk,
    dv)``, by the arithmetic of :func:`flash_bwd_plain`."""
    return _bwd_plain(qt, kt, vt, do, lse, delta, causal, scale, chunk,
                      False, True)[1:]


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


def decode_step_q8_plain(q, kq, vq, kdq, vdq, kcache, vcache, kscale,
                         vscale, cur: int, *, scale: float) -> torch.Tensor:
    """Plain version of ``decode_step_q8``: q ``(rows, dh)`` already
    rotated, the fresh column ``kq``/``vq`` int8 and ``kdq``/``vdq``
    its float32 dequant ``(rows, dh)``, int8 caches ``(rows, total,
    dh)`` and their float32 column scales ``(rows, total)``. Writes
    ``kq``/``vq`` at column ``cur`` of the caches in place and returns
    the float32 attention ``(rows, dh)``, in the order of
    ``_decode_step_q8_kernel``: float32 logits of q against the int8
    past columns times K's column scale, then the logit scale; the
    ``cur`` term from ``kdq``; natural exp; the weights times V's column
    scale before the value product; the ``cur`` value from ``vdq``."""
    kcache[:, cur] = kq
    vcache[:, cur] = vq
    qf = q.float()
    raw = torch.einsum("rd,rtd->rt", qf, kcache[:, :cur].float())
    past = raw * kscale[:, :cur] * scale
    now = (qf * kdq.float()).sum(dim=-1, keepdim=True) * scale
    logits = torch.cat([past, now], dim=-1)
    m = logits.amax(dim=-1, keepdim=True)
    w = torch.exp(logits - m)
    l = w.sum(dim=-1, keepdim=True)
    acc = torch.einsum("rt,rtd->rd", w[:, :cur] * vscale[:, :cur],
                       vcache[:, :cur].float())
    acc = acc + w[:, cur:] * vdq.float()
    return acc / l


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


def _check_bwd(what, qt, kt, vt, do, lse, delta, causal) -> bool:
    """Check a backward's operands; True when they lie on the CPU."""
    _check_flash_shapes(what, qt, kt, vt, causal)
    b, h, sq, d = qt.shape
    if do.shape != qt.shape or lse.shape != (b, h, sq) \
            or delta.shape != lse.shape:
        raise ValueError(f"{what}: do {tuple(do.shape)}, lse "
                         f"{tuple(lse.shape)}, delta {tuple(delta.shape)} "
                         f"do not fit q {tuple(qt.shape)}")
    if qt.device.type == "cpu":
        return True
    _build.check_operands(what, (qt, kt, vt, do), qt.dtype)
    _build.check_operands(f"{what} statistics", (lse, delta), torch.float32)
    _check_head_dim(what, d)
    return False


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
    if _check_bwd("flash_bwd", qt, kt, vt, do, lse, delta, causal):
        return flash_bwd_plain(qt, kt, vt, do, lse, delta, causal, scale)
    b, h, sq, d = qt.shape
    sk = kt.shape[2]
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


def flash_bwd_dq(qt, kt, vt, do, lse, delta, causal: bool, scale: float):
    """dq of the two-pass backward, operands as :func:`flash_bwd`'s;
    returns dq in q's dtype, each row written once by the CTA of its Q
    tile (deterministic).

    The kernel replaces ``icikit/ops/flash_attention.py``'s
    ``_bwd_dq_kernel`` (B8, pallas_call at :745). Bound: three causal
    products (S, dP, dS K) over the card's bf16 rate (operations). CPU
    tensors take :func:`flash_bwd_dq_plain`."""
    if _check_bwd("flash_bwd_dq", qt, kt, vt, do, lse, delta, causal):
        return flash_bwd_dq_plain(qt, kt, vt, do, lse, delta, causal, scale)
    b, h, sq, d = qt.shape
    dq = torch.empty_like(qt)
    lib = _build.load("attention")
    rc = lib.icikit_flash_bwd_dq(
        _build.DTYPE_CODE[qt.dtype], qt.data_ptr(), kt.data_ptr(),
        vt.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), b * h, sq, kt.shape[2], d, int(causal),
        float(scale) * LOG2E, float(scale), _build.stream(qt))
    _build.check(rc, "flash_bwd_dq launch")
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv(qt, kt, vt, do, lse, delta, causal: bool, scale: float):
    """dk and dv of the two-pass backward, operands as
    :func:`flash_bwd`'s; returns ``(dk, dv)``, each key's rows written
    once by the CTA of its key tile.

    The kernel (``flash_bwd``'s with its dq part compiled out) replaces
    ``icikit/ops/flash_attention.py``'s ``_bwd_dkv_kernel`` (B8,
    pallas_call at :771). Bound: four causal products (S, dP, P^T dO,
    dS^T Q), operations. CPU tensors take :func:`flash_bwd_dkv_plain`."""
    if _check_bwd("flash_bwd_dkv", qt, kt, vt, do, lse, delta, causal):
        return flash_bwd_dkv_plain(qt, kt, vt, do, lse, delta, causal,
                                   scale)
    b, h, sq, d = qt.shape
    dk = torch.empty_like(kt)
    dv = torch.empty_like(vt)
    lib = _build.load("attention")
    rc = lib.icikit_flash_bwd_dkv(
        _build.DTYPE_CODE[qt.dtype], qt.data_ptr(), kt.data_ptr(),
        vt.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b * h, sq, kt.shape[2], d,
        int(causal), float(scale) * LOG2E, float(scale), _build.stream(qt))
    _build.check(rc, "flash_bwd_dkv launch")
    LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


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
    if not decode_head_dim_ok(dh) or cos2.numel() != dh \
            or sin2.numel() != dh:
        raise ValueError(f"decode_step: head dim {dh} is not a multiple "
                         f"of {DECODE_CHUNK}, or tables not ({dh},)")
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


def decode_step_q8(q, kq, vq, kdq, vdq, kcache, vcache, kscale, vscale,
                   cur: int, *, scale: float) -> torch.Tensor:
    """One decode step of attention over int8 caches for ``rows = b *
    h`` rows, operands as :func:`decode_step_q8_plain`'s (q float32 or
    bf16); the int8 column ``kq``/``vq`` is written at ``cur`` in place.
    Returns the float32 attention ``(rows, dh)``.

    The kernel replaces ``icikit/ops/flash_attention.py``'s
    ``_decode_step_q8_kernel`` (B14, pallas_call at :1229). Bound:
    reading the ``cur`` past int8 columns of K and V and their scales
    (bytes). CPU tensors take :func:`decode_step_q8_plain`."""
    rows, dh = q.shape
    total = kcache.shape[1]
    if (any(t.shape != q.shape for t in (kq, vq, kdq, vdq))
            or kcache.shape != (rows, total, dh)
            or vcache.shape != kcache.shape
            or kscale.shape != (rows, total)
            or vscale.shape != kscale.shape):
        raise ValueError("decode_step_q8: q and the fresh column must be "
                         "(rows, dh), the caches (rows, total, dh) and "
                         "their scales (rows, total)")
    if not 0 <= cur < total:
        raise ValueError(f"decode_step_q8: cur={cur} outside [0, {total})")
    if q.device.type == "cpu":
        return decode_step_q8_plain(q, kq, vq, kdq, vdq, kcache, vcache,
                                    kscale, vscale, cur, scale=scale)
    _build.check_operands("decode_step_q8 q", (q,), q.dtype)
    _build.check_operands("decode_step_q8 float32 operands",
                          (kdq, vdq, kscale, vscale), torch.float32)
    for t in (kq, vq, kcache, vcache):
        if (t.device.type != "cuda" or t.dtype != torch.int8
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError("decode_step_q8: the fresh column and the "
                             "caches must be contiguous, 16-byte aligned "
                             "CUDA int8 tensors")
    if not decode_head_dim_ok(dh):
        raise ValueError(f"decode_step_q8: head dim {dh} is not a "
                         f"multiple of {DECODE_CHUNK}")
    out = torch.empty((rows, dh), dtype=torch.float32, device=q.device)
    lib = _build.load("attention")
    rc = lib.icikit_decode_step_q8(
        _build.DTYPE_CODE[q.dtype], q.data_ptr(), kq.data_ptr(),
        vq.data_ptr(), kdq.data_ptr(), vdq.data_ptr(), kcache.data_ptr(),
        vcache.data_ptr(), kscale.data_ptr(), vscale.data_ptr(),
        out.data_ptr(), rows, total, dh, int(cur), float(scale),
        _build.stream(q))
    _build.check(rc, "decode_step_q8 launch")
    LAUNCHES["decode_step_q8"] += 1
    return out
