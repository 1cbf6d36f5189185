"""One-pass Adam kernel on Hopper: wrapper, launch count, plain version.

``adam_leaf`` launches ``csrc/adam.cu``'s kernel, which replaces
``icikit/ops/adam.py``'s ``_adam_kernel`` (B12, ``_leaf_update_pallas``,
pallas_call at :71): one pass over a leaf that reads p, m, v and g and
writes p, m and v in place. ``adam_leaf_plain`` is the same function as
PyTorch elementwise ops, the XLA formulation the train step runs by
default (``_leaf_update_xla``); the kernel rounds every operation once in
the same order, so the two agree bit for bit. A wrapper takes the plain
version only for a tensor on the CPU; for a CUDA tensor it launches the
kernel or raises. ``LAUNCHES`` counts kernel launches: one a floating
leaf.

The TPU kernel covers a leaf only when its (rows, 128) view meets the
operands' sublane rule (``_use_pallas``) and leaves the rest to XLA; a
thread here takes any element, so every floating leaf takes the kernel
and that gate decides nothing (the function is the same either way).
"""

from __future__ import annotations

import torch

from icikit_torch.ops import _build

LAUNCHES = {"adam": 0}

_MOMENT_CODE = {torch.float32: 0, torch.bfloat16: 1}
_GRAD_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def adam_leaf_plain(p, m, v, g, scalars, b1: float, b2: float, eps: float,
                    ok=None) -> None:
    """``_leaf_update_xla`` on one leaf, written into p, m and v:
    float32 arithmetic whatever the stored dtypes, the new moments
    rounded once on the store. ``scalars`` is ``adam_scalars``' (3,)
    ``[lr, c1, c2]``. With ``ok`` (a bool scalar tensor) the update
    commits only where it is true, with no host sync."""
    lr, c1, c2 = scalars[0], scalars[1], scalars[2]
    g32 = g.float()
    m32 = m.float() * b1 + g32 * (1.0 - b1)
    v32 = v.float() * b2 + (g32 * g32) * (1.0 - b2)
    p_new = p - lr * (m32 * c1) / (torch.sqrt(v32 * c2) + eps)
    m_new, v_new = m32.to(m.dtype), v32.to(v.dtype)
    if ok is not None:
        p_new = torch.where(ok, p_new, p)
        m_new = torch.where(ok, m_new, m)
        v_new = torch.where(ok, v_new, v)
    p.copy_(p_new)
    m.copy_(m_new)
    v.copy_(v_new)


def adam_leaf(p, m, v, g, scalars, b1: float, b2: float, eps: float,
              ok=None) -> None:
    """Adam on one leaf, in place: p float32; m and v float32 or bf16; g
    float32, bf16 or float16 (widened in registers); ``scalars`` a (3,)
    float32 tensor on p's device; ``ok`` None or a bool scalar tensor on
    it (false: nothing is written). Bound: the bytes of one read of p,
    m, v and g and one write of p, m and v. CPU tensors take
    :func:`adam_leaf_plain`."""
    if not (m.shape == v.shape == g.shape == p.shape):
        raise ValueError(f"adam: shapes p {tuple(p.shape)}, m "
                         f"{tuple(m.shape)}, v {tuple(v.shape)}, g "
                         f"{tuple(g.shape)} disagree")
    if p.device.type == "cpu":
        return adam_leaf_plain(p, m, v, g, scalars, b1, b2, eps, ok)
    for t in (p, m, v, g, scalars) + (() if ok is None else (ok,)):
        if t.device != p.device:
            raise ValueError(f"adam: operands on {t.device} and {p.device}")
    if p.dtype != torch.float32 or scalars.dtype != torch.float32 \
            or scalars.shape != (3,):
        raise ValueError("adam: the kernel takes float32 parameters and "
                         "(3,) float32 scalars")
    if m.dtype != v.dtype or m.dtype not in _MOMENT_CODE:
        raise ValueError(f"adam: moments must share float32 or bfloat16, "
                         f"got {m.dtype}, {v.dtype}")
    if g.dtype not in _GRAD_CODE:
        raise ValueError(f"adam: gradients must be float32, bfloat16 or "
                         f"float16, got {g.dtype}")
    if ok is not None and (ok.dtype != torch.bool or ok.numel() != 1):
        raise ValueError("adam: ok must be one bool")
    if not (p.is_contiguous() and m.is_contiguous() and v.is_contiguous()):
        raise ValueError("adam: p, m and v are written in place and must "
                         "be contiguous")
    g = g.contiguous()
    sc = scalars.contiguous()
    rc = _build.load("adam").icikit_adam(
        _MOMENT_CODE[m.dtype], _GRAD_CODE[g.dtype], p.data_ptr(),
        m.data_ptr(), v.data_ptr(), g.data_ptr(), sc.data_ptr(),
        None if ok is None else ok.data_ptr(), p.numel(), b1, 1.0 - b1, b2,
        1.0 - b2, eps, _build.stream(p))
    _build.check(rc, "adam launch")
    LAUNCHES["adam"] += 1
