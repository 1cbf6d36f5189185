"""Tile-floor study kernels on Hopper: wrappers, launch counts, plain
versions.

``tile_mxu`` and ``tile_ablate`` launch ``csrc/tile_floor.cu``'s
kernels, which replace ``icikit/bench/tile_floor.py``'s ``_mxu_kernel``
(B17, pallas_call at :174) and ``_ablate_kernel`` (B17, :199). All five
run one tile loop, ``flash_fwd``'s at its geometry for d <= 128 (128-row
Q tiles in two consumer warpgroups, 128-key K/V tiles through a TMA
ring, both products on wgmma), over the full rectangle of tiles, and
differ only in what they do to the scores between the two products:

- ``tile_mxu``: o = sum over key tiles of bf16(q k^T * scale_log2) v, the
  two products with the least glue and no softmax statistics;
- ``tile_ablate``: the online-softmax loop with exp2 replaced by a
  subtraction (``use_exp2=False``) and/or the running max by the
  constant 8 (``use_max=False``), from JAX's ``m = -1e30``.

``scale_log2`` is the softmax scale with log2(e) folded in, as the
caller passes it to JAX's kernels. These variants depend on the key
tile: ``alpha`` and the constant max change the result with ``bk``. So
the plain versions (``mxu_plain``, ``ablate_plain``) walk the key tiles
of size ``bk`` (default the kernels' 128) in the kernel's order with
float32 statistics and ``w`` rounded to bf16 before the value product,
JAX's recurrence (``tile_floor.py:80-103``). A wrapper takes the plain
version only for a tensor on the CPU; for a CUDA tensor it launches the
kernel (bf16, head dim 64 or 128) or raises. ``LAUNCHES`` counts kernel
launches.
"""

from __future__ import annotations

import torch

from icikit_torch.ops import _build

LAUNCHES = {"tile_mxu": 0, "tile_ablate": 0}

# The kernels' geometry: 128-row Q and 128-key K/V tiles.
TILE = 128
HEAD_DIMS = (64, 128)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(what, q, k, v, bk: int = TILE) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{what}: q, k, v must share one (b, h, s, d) "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    s = q.shape[2]
    if s % TILE or s % bk:
        raise ValueError(f"{what}: s={s} is not a multiple of the tiles "
                         f"({TILE}, {bk})")


def _key_tiles(k, v, bk: int):
    for n0 in range(0, k.shape[2], bk):
        yield k[:, :, n0:n0 + bk].float(), v[:, :, n0:n0 + bk].float()


def mxu_plain(q, k, v, scale_log2: float, bk: int = TILE) -> torch.Tensor:
    """Plain version of ``tile_mxu`` on ``(b, h, s, d)`` tensors: per key
    tile of ``bk`` keys, ``w = bf16(q k^T * scale_log2)`` and ``acc += w
    v`` in float32; returns ``acc`` in q's dtype."""
    _check("mxu_plain", q, k, v, bk)
    qf = q.float()
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for kt, vt in _key_tiles(k, v, bk):
        w = (torch.matmul(qf, kt.transpose(-1, -2)) * scale_log2).to(v.dtype)
        acc += torch.matmul(w.float(), vt)
    return acc.to(q.dtype)


def ablate_plain(q, k, v, scale_log2: float, use_exp2: bool,
                 use_max: bool, bk: int = TILE) -> torch.Tensor:
    """Plain version of ``tile_ablate`` on ``(b, h, s, d)`` tensors:
    JAX's ``_ablate_kernel`` recurrence over key tiles of ``bk`` keys,
    from ``m = -1e30``, ``l = 0``: ``s = q k^T * scale_log2``; ``m_new``
    the running row max (``use_max``) or 8; ``alpha = exp2(m - m_new)``,
    ``w = exp2(s - m_new)`` (``use_exp2``) or ``alpha = 0.1 (m - m_new) +
    1``, ``w = s - m_new``; ``l = l alpha + rowsum(w)``, ``acc = acc
    alpha + bf16(w) v``. Returns ``acc / l`` in q's dtype."""
    _check("ablate_plain", q, k, v, bk)
    qf = q.float()
    rows = q.shape[:3] + (1,)
    m = torch.full(rows, -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros(rows, dtype=torch.float32, device=q.device)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for kt, vt in _key_tiles(k, v, bk):
        s = torch.matmul(qf, kt.transpose(-1, -2)) * scale_log2
        m_new = (torch.maximum(m, s.amax(dim=-1, keepdim=True)) if use_max
                 else torch.full_like(m, 8.0))
        if use_exp2:
            alpha = torch.exp2(m - m_new)
            w = torch.exp2(s - m_new)
        else:
            alpha = (m - m_new) * 0.1 + 1.0
            w = s - m_new
        l = l * alpha + w.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(w.to(v.dtype).float(), vt)
        m = m_new
    return (acc / l).to(q.dtype)


def _launch(fn: str, what: str, q, k, v, scale_log2: float,
            *flags) -> torch.Tensor:
    _build.check_operands(what, (q, k, v), torch.bfloat16)
    d = q.shape[3]
    if d not in HEAD_DIMS:
        raise ValueError(f"{what}: the kernel takes head dims {HEAD_DIMS}, "
                         f"got d={d}")
    b, h, s, _ = q.shape
    out = torch.empty_like(q)
    rc = getattr(_build.load("tile_floor"), fn)(
        *flags, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b * h, s, d, float(scale_log2), _build.stream(q))
    _build.check(rc, f"{what} launch")
    LAUNCHES[what] += 1
    return out


def tile_mxu(q, k, v, scale_log2: float) -> torch.Tensor:
    """The products-only tile loop on ``(b, h, s, d)`` bf16 tensors;
    returns bf16 ``(b, h, s, d)``. Bound: 4 * 128 * 128 * d operations a
    tile of the rectangle at the card's bf16 rate. CPU tensors take
    :func:`mxu_plain`."""
    _check("tile_mxu", q, k, v)
    if q.device.type == "cpu":
        return mxu_plain(q, k, v, scale_log2)
    return _launch("icikit_tile_mxu", "tile_mxu", q, k, v, scale_log2)


def tile_ablate(q, k, v, scale_log2: float, use_exp2: bool,
                use_max: bool) -> torch.Tensor:
    """The ablated online-softmax tile loop on ``(b, h, s, d)`` bf16
    tensors; returns bf16 ``(b, h, s, d)``. Bound: as :func:`tile_mxu`.
    CPU tensors take :func:`ablate_plain`."""
    _check("tile_ablate", q, k, v)
    if q.device.type == "cpu":
        return ablate_plain(q, k, v, scale_log2, use_exp2, use_max)
    return _launch("icikit_tile_ablate", "tile_ablate", q, k, v, scale_log2,
                   int(bool(use_exp2)), int(bool(use_max)))
