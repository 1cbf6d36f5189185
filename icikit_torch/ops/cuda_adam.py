"""One-pass Adam kernel on Hopper: wrapper, launch count, plain version.

``adam_tree`` launches ``csrc/adam.cu``'s kernel, which replaces
``icikit/ops/adam.py``'s ``_adam_kernel`` (B12, ``_leaf_update_pallas``,
pallas_call at :71): one pass over a tree's floating leaves that reads
p, m, v and g and writes p, m and v in place, one launch for up to
``MAX_LEAVES`` leaves whose moments share a (m dtype, v dtype) pair (the
TPU runs one pallas_call a leaf, each moment in its own dtype).
``adam_leaf`` is a tree of one. ``adam_leaf_plain`` is the same function
on one leaf as PyTorch elementwise ops, the XLA formulation the train
step runs by default (``_leaf_update_xla``), and ``adam_tree_plain`` the
same over a tree; the kernel rounds every operation once in the same
order, so kernel and plain version agree bit for bit. A wrapper takes
the plain version only for a tensor on the CPU; for a CUDA tensor it
launches the kernel or raises. ``LAUNCHES`` counts kernel launches: one
a tree of at most ``MAX_LEAVES`` non-empty leaves and one moment pair.

The TPU kernel covers a leaf only when its (rows, 128) view meets the
operands' sublane rule (``_use_pallas``) and leaves the rest to XLA; a
thread here takes any element, so every floating leaf takes the kernel
and that gate decides nothing (the function is the same either way).
"""

from __future__ import annotations

import ctypes

import torch

from icikit_torch.ops import _build

LAUNCHES = {"adam": 0}

# csrc/adam.cu's leaf table: leaves a launch, and elements a chunk (two
# of its shared-memory tiles), the unit its persistent grid walks
MAX_LEAVES = 48
CHUNK = 4096
_VEC = 8        # a chunk's body is a multiple of 8 elements (16 bytes)
_ROW = 8        # int64 fields a leaf in the C entry's table

# the C entry's code of each (m dtype, v dtype) pair: one kernel each
_MOMENT_CODE = {(torch.float32, torch.float32): 0,
                (torch.bfloat16, torch.bfloat16): 1,
                (torch.float32, torch.bfloat16): 2,
                (torch.bfloat16, torch.float32): 3}
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


def adam_tree_plain(ps, ms, vs, gs, scalars, b1: float, b2: float,
                    eps: float, ok=None) -> None:
    """:func:`adam_leaf_plain` over the leaves of equal-length lists."""
    for p, m, v, g in zip(ps, ms, vs, gs):
        adam_leaf_plain(p, m, v, g, scalars, b1, b2, eps, ok)


def _head(ptrs, sizes) -> int:
    """The fewest leading elements (0-7) after which every pointer,
    advanced by its element size a step, is 16-byte aligned; -1 where
    none is (the leaf then takes the kernel's scalar path)."""
    for h in range(_VEC):
        if all((a + h * s) % 16 == 0 for a, s in zip(ptrs, sizes)):
            return h
    return -1


def _leaf_table(ns, heads, max_leaves: int = MAX_LEAVES,
                chunk: int = CHUNK) -> list:
    """The launches for leaves of ``ns`` elements and ``heads`` (as
    :func:`_head` gives them, at most n): ``[(leaf indices, first chunk
    of each, chunks in all)]``, at most ``max_leaves`` leaves a launch,
    empty leaves left out. A leaf's chunks start after its head (chunk 0
    also takes the head) and number ``ceil((n - head) / chunk)``, at
    least one."""
    launches, idx, firsts, total = [], [], [], 0
    for i, (n, h) in enumerate(zip(ns, heads)):
        if n == 0:
            continue
        if len(idx) == max_leaves:
            launches.append((idx, firsts, total))
            idx, firsts, total = [], [], 0
        idx.append(i)
        firsts.append(total)
        total += max(1, -(-(n - max(h, 0)) // chunk))
    if idx:
        launches.append((idx, firsts, total))
    return launches


def _check_tree(ps, ms, vs, gs, scalars, ok) -> None:
    dev = ps[0].device
    for p, m, v, g in zip(ps, ms, vs, gs):
        for t in (p, m, v, g):
            if t.device != dev:
                raise ValueError(f"adam: operands on {t.device} and {dev}")
        if p.dtype != torch.float32:
            raise ValueError("adam: the kernel takes float32 parameters")
        if (m.dtype, v.dtype) not in _MOMENT_CODE:
            raise ValueError(f"adam: moments must be float32 or bfloat16, "
                             f"got m {m.dtype}, v {v.dtype}")
        if g.dtype not in _GRAD_CODE:
            raise ValueError(f"adam: gradients must be float32, bfloat16 or "
                             f"float16, got {g.dtype}")
        if not (p.is_contiguous() and m.is_contiguous()
                and v.is_contiguous()):
            raise ValueError("adam: p, m and v are written in place and "
                             "must be contiguous")
    if scalars.device != dev or scalars.dtype != torch.float32 \
            or scalars.shape != (3,):
        raise ValueError("adam: the kernel takes (3,) float32 scalars on "
                         "the parameters' device")
    if ok is not None and (ok.device != dev or ok.dtype != torch.bool
                           or ok.numel() != 1):
        raise ValueError("adam: ok must be one bool on the parameters' "
                         "device")


def adam_tree(ps, ms, vs, gs, scalars, b1: float, b2: float, eps: float,
              ok=None) -> None:
    """Adam over a tree's floating leaves, in place, one launch for each
    ``MAX_LEAVES`` non-empty leaves of one (m dtype, v dtype) pair (a
    tree whose moments share one pair takes one launch): ``ps`` float32;
    each of ``ms`` and ``vs`` float32 or bf16; each of ``gs`` float32,
    bf16 or float16
    (widened in registers); lists in one order. ``scalars`` a (3,)
    float32 tensor on their device; ``ok`` None or a bool scalar tensor
    on it (false: nothing is written). Bound: the bytes of one read of
    p, m, v and g and one write of p, m and v. CPU tensors take
    :func:`adam_tree_plain`."""
    ps, ms, vs, gs = list(ps), list(ms), list(vs), list(gs)
    if not (len(ps) == len(ms) == len(vs) == len(gs)):
        raise ValueError("adam: p, m, v and g lists differ in length")
    for p, m, v, g in zip(ps, ms, vs, gs):
        if not (m.shape == v.shape == g.shape == p.shape):
            raise ValueError(f"adam: shapes p {tuple(p.shape)}, m "
                             f"{tuple(m.shape)}, v {tuple(v.shape)}, g "
                             f"{tuple(g.shape)} disagree")
    if not ps:
        return
    if ps[0].device.type == "cpu":
        return adam_tree_plain(ps, ms, vs, gs, scalars, b1, b2, eps, ok)
    _check_tree(ps, ms, vs, gs, scalars, ok)
    entry = _build.load("adam").icikit_adam_tree
    for idx in _pairs(ms, vs).values():
        LAUNCHES["adam"] += _launch(
            entry, *([d[i] for i in idx] for d in (ps, ms, vs, gs)),
            scalars, b1, b2, eps, ok, _build.stream(ps[0]))


def _pairs(ms, vs) -> dict:
    """The leaves' indices by (m dtype, v dtype), in the tree's order."""
    groups = {}
    for i, (m, v) in enumerate(zip(ms, vs)):
        groups.setdefault((m.dtype, v.dtype), []).append(i)
    return groups


def _launch(entry, ps, ms, vs, gs, scalars, b1, b2, eps, ok, stream) -> int:
    """Launch ``entry`` (a library's ``icikit_adam_tree``) over checked
    leaves of one moment pair, one launch a ``_leaf_table`` launch;
    returns the launches."""
    gs = [g.contiguous() for g in gs]
    code = _MOMENT_CODE[(ms[0].dtype, vs[0].dtype)]
    ns = [p.numel() for p in ps]
    heads = [min(_head((p.data_ptr(), m.data_ptr(), v.data_ptr(),
                        g.data_ptr()), (4, m.element_size(), v.element_size(),
                                        g.element_size())),
                 n) for p, m, v, g, n in zip(ps, ms, vs, gs, ns)]
    sc = scalars.contiguous()
    okp = None if ok is None else ok.data_ptr()
    launches = _leaf_table(ns, heads)
    for idx, firsts, _ in launches:
        rows = []
        for i, c0 in zip(idx, firsts):
            rows += [ps[i].data_ptr(), ms[i].data_ptr(), vs[i].data_ptr(),
                     gs[i].data_ptr(), ns[i], c0, _GRAD_CODE[gs[i].dtype],
                     heads[i]]
        table = (ctypes.c_int64 * (_ROW * len(idx)))(*rows)
        rc = entry(code, table, len(idx), CHUNK,
                   sc.data_ptr(), okp, b1, 1.0 - b1, b2, 1.0 - b2, eps,
                   stream)
        _build.check(rc, "adam launch")
    return len(launches)


def adam_leaf(p, m, v, g, scalars, b1: float, b2: float, eps: float,
              ok=None) -> None:
    """Adam on one leaf, in place: :func:`adam_tree` over a tree of one
    (one launch). CPU tensors take :func:`adam_leaf_plain`."""
    adam_tree([p], [m], [v], [g], scalars, b1, b2, eps, ok)
