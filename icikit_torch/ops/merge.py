"""Bitonic merge network and compare-split halves.

For ascending sorted ``a`` and ``b``, ``L = min(a, reverse(b))`` and
``H = max(a, reverse(b))`` are each bitonic, every element of L is <=
every element of H, and {L, H} are the n smallest / n largest of the 2n
inputs (Batcher). One elementwise min/max pass replaces the reference's
two-pointer compare-split merge (``psort.cc:116-164``), and a bitonic
merge network sorts the kept half.
"""

from __future__ import annotations

import torch

from icikit_torch.utils.mesh import is_pow2


def bitonic_merge(v: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """Sort a *bitonic* vector ascending via Batcher's merge network;
    a 2-D ``(rows, n)`` input merges each row.

    On a CUDA tensor of at least ``MIN_KERNEL`` int32/uint32/float32
    elements the merge is the kernel network
    (``icikit_torch.ops.cuda_sort.merge_bitonic``). On the CPU, below
    that size, and with ``backend="torch"``, it is the plain stage loop
    of log2(n) elementwise min/max passes. Non-power-of-2 lengths go to
    ``torch.sort``.
    """
    n = v.shape[-1]
    if not is_pow2(n):
        return torch.sort(v, dim=-1).values
    from icikit_torch.ops.cuda_sort import kernel_supported, merge_bitonic
    if backend not in ("auto", "kernel", "torch"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "kernel" or (backend == "auto" and v.is_cuda
                               and kernel_supported(v.dtype, n)):
        return merge_bitonic(v, backend="kernel")
    shape = v.shape
    k = n // 2
    while k >= 1:
        w = v.reshape(-1, 2, k)
        lo = torch.minimum(w[:, 0], w[:, 1])
        hi = torch.maximum(w[:, 0], w[:, 1])
        v = torch.stack([lo, hi], dim=1).reshape(shape)
        k //= 2
    return v


def compare_split_min(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The n smallest of sorted ``a`` + sorted ``b``, sorted ascending
    (reference ``compare_split_min``, ``psort.cc:142-164``)."""
    return bitonic_merge(torch.minimum(a, b.flip(-1)))


def compare_split_max(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The n largest of sorted ``a`` + sorted ``b``, sorted ascending
    (reference ``compare_split_max``, ``psort.cc:116-140``)."""
    return bitonic_merge(torch.maximum(a, b.flip(-1)))
