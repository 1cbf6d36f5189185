"""Save-stack kernels on Hopper: wrappers, launch counts, plain versions.

``stack_write`` and ``stack_read`` launch ``csrc/stack_write.cu``'s
kernels, which replace ``icikit/ops/stack_write.py``'s ``_write_kernel``
(B16, ``stack_write``, pallas_call at :126) and ``_read_kernel`` (B16,
``stack_read``, :158): one slice of an ``(L, ...)`` stack written in
place, or read out, as a copy of its bytes. ``stack_write_plain`` and
``stack_read_plain`` are the same functions as one PyTorch op each; a
copy has one answer, so kernel and plain version agree bit for bit. A
wrapper takes the plain version only for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises (the C entry refuses a slice
index outside the stack; ``ops.stack_write`` checks it for its callers).
``SliceCopier`` is the same pair for a loop over one stack, the stack
checked once. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

from icikit_torch.ops import _build

LAUNCHES = {"stack_write": 0, "stack_read": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def stack_write_plain(stack: torch.Tensor, x: torch.Tensor,
                      i: int) -> torch.Tensor:
    """``stack[i] = x`` in place (x cast to the stack's dtype); returns
    the stack."""
    stack[i].copy_(x.reshape(stack.shape[1:]))
    return stack


def stack_read_plain(stack: torch.Tensor, i: int) -> torch.Tensor:
    """A copy of ``stack[i]``."""
    return stack[i].clone()


_ENTRIES: list = []   # (write, read): the C entries, bound at first use


def _entries():
    if not _ENTRIES:
        lib = _build.load("stack_write")
        _ENTRIES[:] = [lib.icikit_stack_write, lib.icikit_stack_read]
    return _ENTRIES


def _check_cuda(what: str, stack: torch.Tensor, other: torch.Tensor) -> int:
    """Raise unless both are contiguous CUDA tensors of one dtype on one
    device, 16-byte aligned with a slice a multiple of 16 bytes; returns
    the slice's bytes."""
    for t in (stack, other):
        if t.device != stack.device or t.device.type != "cuda":
            raise ValueError(f"{what}: expected CUDA or CPU tensors on one "
                             f"device, got {stack.device} and "
                             f"{other.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: operands must be contiguous and "
                             "16-byte aligned")
    if other.dtype != stack.dtype:
        raise ValueError(f"{what}: the kernel copies bytes of the stack's "
                         f"dtype {stack.dtype}, got {other.dtype}")
    nbytes = other.numel() * other.element_size()
    if nbytes % 16:
        raise ValueError(f"{what}: a slice of {nbytes} bytes is not a "
                         "multiple of 16")
    return nbytes


def stack_write(stack: torch.Tensor, x: torch.Tensor, i: int
                ) -> torch.Tensor:
    """``stack[i] = x`` in place, ``x`` with a slice's elements in the
    stack's dtype; returns the stack. Bound: one read and one write of
    the slice (bytes). CPU tensors take :func:`stack_write_plain`."""
    if x.numel() != stack[0].numel():
        raise ValueError(f"stack_write: {x.numel()} elements for a slice "
                         f"of {stack[0].numel()}")
    if stack.device.type == "cpu" and x.device.type == "cpu":
        return stack_write_plain(stack, x, i)
    nbytes = _check_cuda("stack_write", stack, x)
    rc = _entries()[0](stack.data_ptr(), x.data_ptr(), i, stack.shape[0],
                       nbytes, _build.stream(stack))
    _build.check(rc, "stack_write launch")
    LAUNCHES["stack_write"] += 1
    return stack


def stack_read(stack: torch.Tensor, i: int) -> torch.Tensor:
    """A copy of ``stack[i]``, shaped as ``stack.shape[1:]``. Bound: one
    read and one write of the slice (bytes). CPU tensors take
    :func:`stack_read_plain`."""
    if stack.device.type == "cpu":
        return stack_read_plain(stack, i)
    out = torch.empty(stack.shape[1:], dtype=stack.dtype,
                      device=stack.device)
    nbytes = _check_cuda("stack_read", stack, out)
    rc = _entries()[1](stack.data_ptr(), out.data_ptr(), i, stack.shape[0],
                       nbytes, _build.stream(stack))
    _build.check(rc, "stack_read launch")
    LAUNCHES["stack_read"] += 1
    return out


class SliceCopier:
    """One stack's slice copies for a loop that writes and reads it
    many times: the stack (device, dtype, contiguity, alignment, slice
    bytes), the C entries and the current stream are checked and taken
    once, here, so that a call checks only its index and ``x``'s dtype
    (cast to the stack's), device, contiguity and alignment before the
    launch. The stream is the one current when the copier is made. A CPU
    stack takes the plain copies."""

    __slots__ = ("stack", "n", "numel", "nbytes", "dtype", "device",
                 "shape", "_ptr", "_dev", "_stream", "_write", "_read")

    def __init__(self, stack: torch.Tensor):
        self.stack, self.n = stack, stack.shape[0]
        self.shape, self.dtype = tuple(stack.shape[1:]), stack.dtype
        self.device = stack.device
        self.numel = stack[0].numel()
        if stack.device.type == "cpu":
            self._dev = None
            return
        self.nbytes = _check_cuda("stack", stack, stack[0])
        self._ptr, self._dev = stack.data_ptr(), stack.get_device()
        self._stream = _build.stream(stack)
        self._write, self._read = _entries()

    def _index(self, i) -> int:
        if type(i) is not int or not 0 <= i < self.n:
            raise ValueError(f"stack index {i!r} must be a Python int in "
                             f"[0, {self.n})")
        return i

    def write(self, x: torch.Tensor, i: int) -> None:
        """``stack[i] = x`` in place, ``x`` cast to the stack's dtype."""
        i = self._index(i)
        if self._dev is None:
            stack_write_plain(self.stack, x, i)
            return
        if x.dtype != self.dtype:
            x = x.to(self.dtype)
        if not x.is_contiguous():
            x = x.contiguous()
        if x.get_device() != self._dev or x.numel() != self.numel \
                or x.data_ptr() % 16:
            raise ValueError(f"stack_write: x must hold {self.numel} "
                             f"elements on {self.device}, 16-byte aligned; "
                             f"got {x.numel()} on {x.device}")
        rc = self._write(self._ptr, x.data_ptr(), i, self.n, self.nbytes,
                         self._stream)
        if rc:
            _build.check(rc, "stack_write launch")
        LAUNCHES["stack_write"] += 1

    def read(self, i: int) -> torch.Tensor:
        """A copy of ``stack[i]``, shaped as ``stack.shape[1:]``."""
        i = self._index(i)
        if self._dev is None:
            return stack_read_plain(self.stack, i)
        out = torch.empty(self.shape, dtype=self.dtype, device=self.device)
        rc = self._read(self._ptr, out.data_ptr(), i, self.n, self.nbytes,
                        self._stream)
        if rc:
            _build.check(rc, "stack_read launch")
        LAUNCHES["stack_read"] += 1
        return out
