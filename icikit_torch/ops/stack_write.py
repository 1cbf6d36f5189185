"""Save stack: per-layer residuals in an explicit ``(L, ...)`` stack,
written and read one slice at a time, and the layer loop that uses it.

The port of ``icikit/ops/stack_write.py``. JAX wrote it to pin the
layouts of the stacked save buffers against XLA's layout copies (B16);
a buffer on the card has no layout to pin, so here the writer and the
reader are plain copies of one slice (``ops.cuda_stack``), in place for
the write. ``stack_supported`` is JAX's gate, copied exactly: a slice
goes to the kernels exactly where JAX sends it to Pallas, so launch
counts compare; any other slice takes the plain copy, a route decided
from the shape before any launch, as JAX falls back to
``dynamic_update_index_in_dim``.

``remat_scan_stacked`` is the layer loop with that stack: the forward
runs the layers without a graph, writing each layer's input into the
stack first; the backward walks the layers in reverse, reads each input
back, rebuilds the layer under autograd (full-layer rematerialization)
and writes each parameter gradient into its own ``(L, ...)`` stack
through the same writer. The TPU measurement of this path (JAX's
docstring: +6.3 ms a step against the XLA scan) is JAX's, taken on a
TPU; the port measures its own (``chip_smoke.py``).
"""

from __future__ import annotations

import math

import torch

from icikit_torch.ops import cuda_stack
# the plain versions, beside the kernels: stack[i].copy_(x), stack[i].clone()
from icikit_torch.ops.cuda_stack import (stack_read_plain,  # noqa: F401
                                         stack_write_plain)

_LANES = 128
# JAX's widest block row count; the gate below keeps its block-row list
_MAX_BLOCK_ROWS = 1024


def _sublane(dtype) -> int:
    """JAX's ``pallas_common.sublane``: the second-minor tiling multiple,
    32 / itemsize rows, at least 8 (8 for 4-byte types, 16 for 2-byte,
    32 for 1-byte)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return max(8, 32 // max(1, itemsize))


def _row_tiles(slice_size: int, dtype):
    """(rows, block_rows) of the (rows, 128) view of one stack slice, or
    None when JAX's kernel could not tile it (the plain route)."""
    if slice_size % _LANES:
        return None
    rows = slice_size // _LANES
    sub = _sublane(dtype)
    if rows % sub:
        return None
    for br in (_MAX_BLOCK_ROWS, 512, 256, 128, 64, 32, 16, 8):
        if br >= sub and rows % br == 0:
            return rows, br
    return None


def stack_supported(slice_shape, dtype) -> bool:
    """Whether the kernels take one ``(L, *slice_shape)`` stack's slices;
    else ``stack_write``/``stack_read`` take the plain copy for it."""
    size = math.prod(slice_shape) if slice_shape else 1
    return _row_tiles(int(size), dtype) is not None


def _check_index(stack: torch.Tensor, i) -> int:
    if isinstance(i, torch.Tensor) or not 0 <= int(i) < stack.shape[0]:
        raise ValueError(f"stack index {i!r} must be a Python int in "
                         f"[0, {stack.shape[0]})")
    return int(i)


def stack_write(stack: torch.Tensor, x: torch.Tensor, i: int
                ) -> torch.Tensor:
    """``stack[i] = x`` in place, ``x`` cast to the stack's dtype first;
    returns the stack (the caller's tensor: JAX donates it). A slice off
    the gate takes :func:`stack_write_plain`."""
    i = _check_index(stack, i)
    if _row_tiles(x.numel(), stack.dtype) is None:
        return stack_write_plain(stack, x, i)
    return cuda_stack.stack_write(stack, x.to(stack.dtype).contiguous(), i)


def stack_read(stack: torch.Tensor, i: int, slice_shape=None
               ) -> torch.Tensor:
    """A copy of ``stack[i]``, shaped ``slice_shape`` (default
    ``stack.shape[1:]``). A slice off the gate takes
    :func:`stack_read_plain`."""
    i = _check_index(stack, i)
    shape = tuple(slice_shape or stack.shape[1:])
    if _row_tiles(math.prod(shape) if shape else 1, stack.dtype) is None:
        return stack_read_plain(stack, i).reshape(shape)
    return cuda_stack.stack_read(stack, i).reshape(shape)


def _copier(impl: str, stack: torch.Tensor):
    """(write(x, i), read(i)) for one stack of the layer loop: where
    ``impl`` is "pallas" and JAX's gate takes the stack's slices, the
    slice kernels through a ``cuda_stack.SliceCopier`` (the stack
    checked once; a CPU stack takes the plain copies there); else the
    plain copies."""
    if impl == "pallas" and stack_supported(stack.shape[1:], stack.dtype):
        c = cuda_stack.SliceCopier(stack)
        return c.write, c.read
    return (lambda x, i: stack_write_plain(stack, x, i),
            lambda i: stack_read_plain(stack, i))


class _RematScanStacked(torch.autograd.Function):
    """JAX's ``run`` custom_vjp (``stack_write.py:209-249``): forward
    ``run_fwd``, backward ``run_bwd``. ``leaves`` are the stacked
    parameters in ``keys``' order."""

    @staticmethod
    def forward(ctx, layer_fn, impl, keys, positions, x0, *leaves):
        n_layers = leaves[0].shape[0]
        # every slice is written before it is read: no zero fill
        stack = torch.empty((n_layers,) + tuple(x0.shape), dtype=x0.dtype,
                            device=x0.device)
        write = _copier(impl, stack)[0]
        x = x0
        aux = torch.zeros((), dtype=torch.float32, device=x0.device)
        for l in range(n_layers):
            write(x, l)
            x, a = layer_fn(x, {k: t[l] for k, t in zip(keys, leaves)},
                            positions)
            aux = aux + a
        ctx.save_for_backward(stack, positions, *leaves)
        ctx.layer_fn, ctx.impl, ctx.keys = layer_fn, impl, keys
        return x, aux

    @staticmethod
    def backward(ctx, dx, daux):
        stack, positions, *leaves = ctx.saved_tensors
        read = _copier(ctx.impl, stack)[1]
        daux = daux.float()
        dstacks = [torch.empty_like(t) for t in leaves]
        writes = [_copier(ctx.impl, s)[0] for s in dstacks]
        for l in reversed(range(len(stack))):
            with torch.enable_grad():
                x_l = read(l).requires_grad_(True)
                lp = {k: t[l].detach().requires_grad_(True)
                      for k, t in zip(ctx.keys, leaves)}
                y, a = ctx.layer_fn(x_l, lp, positions)
                outs, cts = [y], [dx]
                if a.requires_grad:
                    outs.append(a)
                    cts.append(daux)
                grads = torch.autograd.grad(outs, [x_l, *lp.values()], cts,
                                            allow_unused=True)
            dx = grads[0] if grads[0] is not None else torch.zeros_like(x_l)
            for write, g, t in zip(writes, grads[1:], leaves):
                # a leaf the layer does not use gets zeros, as in JAX
                write(torch.zeros_like(t[l]) if g is None else g, l)
        return (None, None, None, None, dx, *dstacks)


def remat_scan_stacked(layer_fn, x0: torch.Tensor, stacked_params: dict,
                       positions: torch.Tensor, impl: str = "pallas"):
    """The layer loop with an explicit save stack: ``lax.scan``
    semantics, differentiable in ``x0`` and every stacked parameter.

    ``layer_fn(x, layer_slice, positions) -> (x_next, aux_scalar)``, with
    ``layer_slice`` the dict of the stacked parameters' slices for one
    layer. Returns ``(x_final, aux_sum)``, aux summed in float32.

    Forward: each layer's input is written into a preallocated ``(L,
    ...)`` stack by the ``impl`` writer, with no autograd graph.
    Backward: in reverse, each input is read back and the layer rebuilt
    under autograd (full-layer rematerialization); each parameter
    gradient is written into its own ``(L, ...)`` stack through the same
    writer. ``impl="xla"`` runs the same structure with the plain copies
    (JAX's A/B control)."""
    if impl not in ("pallas", "xla"):
        raise ValueError(f"unknown save-stack impl {impl!r} "
                         "(known: pallas, xla)")
    keys = tuple(stacked_params)
    if not keys:
        raise ValueError("remat_scan_stacked needs stacked params")
    return _RematScanStacked.apply(layer_fn, impl, keys, positions, x0,
                                   *(stacked_params[k] for k in keys))
