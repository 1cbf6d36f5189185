"""Fused softmax cross-entropy head (vocab-chunked), on Hopper.

The port of ``icikit/ops/xent.py``. The unfused head materializes the
(T, V) float32 logits between the head product and the loss; the fused
one forms each logits tile inside the kernel and keeps only per-token
statistics (``ops.cuda_xent.xent_fwd``, the counterpart of B9), and its
backward rebuilds g = (softmax - onehot) dnll tile by tile and contracts
it on the spot (``xent_dx_saved``/``xent_dw_saved``, B10), so the g
matrix never reaches device memory.

Ported: the saved-exponential flavour with the fused backward
(``save_exp=True, fused_bwd=True``, the train step's default). Refused
loudly, naming their ROADMAP rows: the recompute flavour of the fused
backward (``save_exp=False``, B10's recompute kernels) and the matmul
backward (``fused_bwd=False``, B11).

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
    """The ``_xent`` custom_vjp (``xent.py:426-476``), saved flavour with
    the fused backward: the forward keeps (e, mrun, lse) as residuals,
    the backward launches the dx and dw kernels."""

    @staticmethod
    def forward(ctx, x, w, targets):
        lse, tgt, e, mrun = cuda_xent.xent_fwd(x, w, targets, save=True)
        ctx.save_for_backward(x, w, targets, lse, e, mrun)
        return lse - tgt

    @staticmethod
    def backward(ctx, dnll):
        x, w, targets, lse, e, mrun = ctx.saved_tensors
        dnll = dnll.float().contiguous()
        dx = cuda_xent.xent_dx_saved(e, mrun, w, targets, lse, dnll)
        dw = cuda_xent.xent_dw_saved(e, mrun, x, targets, lse, dnll)
        return dx.to(x.dtype), dw.to(w.dtype), None


def fused_xent(x: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
               block_t: int = BLOCK_T, block_v: int = BLOCK_V,
               save_exp: bool = False,
               fused_bwd: bool = True) -> torch.Tensor:
    """Per-token cross-entropy ``-log softmax(x @ w^T)[target]``, ``(T,)``
    float32, differentiable in x and w.

    x ``(T, D)`` and w ``(V, D)`` share one dtype (bf16 or float32);
    targets ``(T,)`` integer class ids in ``[0, V)``. Raises
    ``ValueError`` for shapes JAX's tiling cannot cover (callers gate on
    :func:`xent_supported`) and ``NotImplementedError`` for the flavours
    not ported yet."""
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
    if not fused_bwd:
        raise NotImplementedError(
            "fused_xent(fused_bwd=False), the matmul backward that writes "
            "g out (TPU kernel B11), is not ported yet (ROADMAP B11)")
    if not save_exp:
        raise NotImplementedError(
            "fused_xent(save_exp=False), the recompute flavour of the "
            "fused backward (TPU kernel B10's _dx_kernel/_dw_kernel), is "
            "not ported yet (ROADMAP B10, recompute flavour)")
    return _Xent.apply(x, w, targets.to(torch.int32))
