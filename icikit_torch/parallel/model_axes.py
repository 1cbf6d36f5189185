"""Reductions over the axes of the model mesh: JAX's ``lax.psum`` and
``pvary`` for rank-vectorised tensors.

Inside the model's per-rank program (``models/transformer/model.py``) a
tensor holds the ranks of one or more mesh axes as dims of its own, and
each such dim holds the ranks this process has of that axis. Two
operations move values between ranks of an axis, each an
``autograd.Function`` whose backward is its transpose:

- :func:`psum` sums over the axis and gives every rank the sum
  (``lax.psum``). It runs the ``allreduce`` family's ``xla`` variant
  through ``shmap.run_collective`` over that axis's rows, as JAX's psum
  is XLA's; across processes (the dp axis of a multi-process mesh) that
  is the process backend's all-reduce. Its transpose is itself: the
  cotangent of the sum on every rank is summed back.
- :func:`pvary` broadcasts a value that is replicated over the axis to
  each of its ranks, one copy a rank (the value enters the per-rank
  program, where JAX inserts it when a replicated parameter meets a
  varying one). Its transpose is the psum: the per-rank cotangents are
  summed over the axis, and that sum is the gradient of the replicated
  value. This is the gradient sync over dp.

An axis of one rank is the identity both ways, as in JAX. A psum over
several axes runs one axis at a time, sp, then tp, then dp, so a sum
that crosses processes adds the same per-process partials in every run.
"""

from __future__ import annotations

import torch

from icikit_torch.parallel.shmap import run_collective

# The order a multi-axis sum reduces a model mesh's axes in: dp, the
# axis that may cross processes, last.
SUM_ORDER = ("sp", "tp", "dp")


def _allreduce(x: torch.Tensor, mesh, axis: str, dim: int,
               op: str) -> torch.Tensor:
    """``op`` over dim ``dim`` of ``x``, which holds this process's ranks
    of ``axis``; every rank gets the result."""
    y = run_collective("allreduce", "xla", mesh.axis_mesh(axis), axis,
                       x.movedim(dim, 0), op)
    return y.movedim(0, dim)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _allreduce(x, mesh, axis, dim, "sum")

    @staticmethod
    def backward(ctx, g):
        return _allreduce(g, ctx.mesh, ctx.axis, ctx.dim, "sum"), None, \
            None, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        shape = list(x.shape)
        for axis, dim in dims:
            shape[dim] = mesh.local_size(axis)
        return x.expand(shape).contiguous()

    @staticmethod
    def backward(ctx, g):
        for axis, dim in sorted(ctx.dims,
                                key=lambda ad: SUM_ORDER.index(ad[0])):
            g = _allreduce(g, ctx.mesh, axis, dim, "sum").narrow(dim, 0, 1)
        return g, None, None


def psum(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """``lax.psum(x, axis)``: dim ``dim`` of ``x`` holds the ranks of
    ``axis`` (this process's); every rank gets their sum.
    Differentiable; the identity on an axis of one rank."""
    if mesh.shape[axis] == 1:
        return x
    return _Psum.apply(x, mesh, axis, dim)


def pvary(x: torch.Tensor, mesh, dims: dict) -> torch.Tensor:
    """The per-rank copies of a value replicated over some axes:
    ``dims`` maps each such axis to a dim of ``x`` of size 1, which
    becomes that axis's ranks (this process's), one copy each. The
    backward sums the copies' cotangents over each axis by
    :func:`psum`. Axes of one rank are left as they are."""
    dims = tuple((a, d) for a, d in dims.items() if mesh.shape[a] > 1)
    for _, d in dims:
        if x.shape[d] != 1:
            raise ValueError(f"pvary broadcasts a dim of size 1; dim {d} "
                             f"of {tuple(x.shape)} is not")
    if not dims:
        return x
    return _Pvary.apply(x, mesh, dims)


def pmax(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The maximum over ``axis`` on every rank, outside autograd: the
    stability shift of a distributed softmax, whose gradient cancels
    (JAX takes it through an all_gather under ``stop_gradient``)."""
    x = x.detach()
    if mesh.shape[axis] == 1:
        return x
    return _allreduce(x, mesh, axis, dim, "max")
