"""Fused softmax cross-entropy head (vocab-chunked), on Hopper.

The port of ``icikit/ops/xent.py``. The unfused head materializes the
(T, V) float32 logits between the head product and the loss; the fused
one forms each logits tile inside the kernel and keeps only per-token
statistics (``ops.cuda_xent.xent_fwd``, the counterpart of B9). Its
backward comes in JAX's four flavours, save_exp x fused_bwd:

- fused (the default): dx and dw come straight out of two kernels that
  rebuild each tile of g = (softmax - onehot) dnll and contract it on the
  spot, so g never reaches device memory; g is rebuilt from the saved
  exponentials (``xent_dx_saved``/``xent_dw_saved``, B10 saved) or from
  a recomputed logits tile (``xent_dx``/``xent_dw``, B10 recompute).
- matmul (``fused_bwd=False``): one kernel writes g as a (T, V) tensor
  in the compute dtype (``xent_g_saved`` or ``xent_g``, B11) and dx =
  g w, dw = g^T x are plain matmuls, as JAX leaves them to XLA.

The head weight is taken (V, D), embedding orientation, as in JAX. On
a CPU tensor the kernels' plain versions run.
"""

from __future__ import annotations

import torch

from icikit_torch.ops import cuda_xent

# The JAX package's default tile geometry: the gate below takes JAX's
# decision with it. The kernels' own tiles are 128 x 128 (bf16) and
# 64 x 64 (float32) and cover any T.
BLOCK_T = 1024
BLOCK_V = 2048


def _tiles(t, v, block_t, block_v):
    bt = min(block_t, t)
    bv = min(block_v, v)
    if t % bt or v % bv:
        return None
    return bt, bv


def xent_supported(t: int, d: int, v: int, dtype,
                   block_t: int = BLOCK_T, block_v: int = BLOCK_V) -> bool:
    """Whether the fused head covers this shape: JAX's decision
    (``icikit/ops/xent.py:479-489``: float32 or bf16, d % 128 == 0,
    T % min(block_t, T) == 0, V % min(block_v, V) == 0), so that both
    packages take the same head. Else callers take the unfused
    log_softmax path."""
    if dtype not in (torch.bfloat16, torch.float32):
        return False
    return d % 128 == 0 and _tiles(t, v, block_t, block_v) is not None


class _Xent(torch.autograd.Function):
    """The ``_xent`` custom_vjp (``xent.py:426-476``) in its four
    flavours: with ``save`` the forward keeps (e, mrun) beside (x, w,
    targets, lse) as residuals; the backward is ``_xent_bwd``'s, fused
    or matmul by ``fuse``."""

    @staticmethod
    def forward(ctx, x, w, targets, save, fuse):
        if save:
            lse, tgt, e, mrun = cuda_xent.xent_fwd(x, w, targets, save=True)
            ctx.save_for_backward(x, w, targets, lse, e, mrun)
        else:
            lse, tgt = cuda_xent.xent_fwd(x, w, targets, save=False)
            ctx.save_for_backward(x, w, targets, lse)
        ctx.save, ctx.fuse = save, fuse
        return lse - tgt

    @staticmethod
    def backward(ctx, dnll):
        x, w, targets, lse, *saved = ctx.saved_tensors
        dnll = dnll.float().contiguous()
        if ctx.fuse and ctx.save:
            e, mrun = saved
            dx = cuda_xent.xent_dx_saved(e, mrun, w, targets, lse, dnll)
            dw = cuda_xent.xent_dw_saved(e, mrun, x, targets, lse, dnll)
        elif ctx.fuse:
            dx = cuda_xent.xent_dx(x, w, targets, lse, dnll)
            dw = cuda_xent.xent_dw(x, w, targets, lse, dnll)
        else:
            g = (cuda_xent.xent_g_saved(*saved, targets, lse, dnll)
                 if ctx.save else
                 cuda_xent.xent_g(x, w, targets, lse, dnll))
            # JAX's out-of-kernel products (xent.py:469-475): float32
            # accumulation, one rounding to the operand dtype
            dx = torch.matmul(g, w)
            dw = torch.matmul(g.t(), x)
        return dx.to(x.dtype), dw.to(w.dtype), None, None, None


def fused_xent(x: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
               block_t: int = BLOCK_T, block_v: int = BLOCK_V,
               save_exp: bool = False,
               fused_bwd: bool = True) -> torch.Tensor:
    """Per-token cross-entropy ``-log softmax(x @ w^T)[target]``, ``(T,)``
    float32, differentiable in x and w.

    x ``(T, D)`` and w ``(V, D)`` share one dtype (bf16 or float32);
    targets ``(T,)`` integer class ids in ``[0, V)``. ``save_exp`` keeps
    the forward's exponentials for the backward instead of recomputing
    the logits; ``fused_bwd=False`` writes g out and contracts it with
    two matmuls. Raises ``ValueError`` for shapes JAX's tiling cannot
    cover (callers gate on :func:`xent_supported`)."""
    t, d = x.shape
    v = w.shape[0]
    if w.shape[1] != d or targets.shape != (t,):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, targets {tuple(targets.shape)}")
    if x.dtype != w.dtype:
        raise ValueError(f"dtype mismatch: x {x.dtype} vs w {w.dtype} "
                         "(the fused head requires one shared dtype; "
                         "cast the narrower operand up, or both down)")
    if _tiles(t, v, block_t, block_v) is None or d % 128:
        raise ValueError(
            f"fused xent needs T divisible by min(block_t={block_t}, T), "
            f"V divisible by min(block_v={block_v}, V) and D % 128 == 0; "
            f"got T={t} D={d} V={v} (use the unfused path)")
    return _Xent.apply(x, w, targets.to(torch.int32), bool(save_exp),
                       bool(fused_bwd))
