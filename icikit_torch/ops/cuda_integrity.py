"""The checked transport's checksum on Hopper: wrapper, launch count,
plain version.

``segment_checksum`` launches ``csrc/integrity.cu``'s
``segment_checksum_kernel``. It replaces no Pallas kernel: in JAX the
fold is XLA ops fused into the exchange
(``icikit/parallel/transport.py:124-146``). PyTorch has no XOR
reduction, so the plain version, :func:`segment_checksum_plain`, folds
by halving (log2 n ops after the rotation); it is the oracle on the CPU
and on the card. Kernel and plain version agree bit for bit: the fold
is exact integer work. A CUDA tensor always takes the kernel, unless
``plain=True`` is asked for; a failed build or launch raises.
``LAUNCHES`` counts kernel launches (a segment of no elements launches
nothing).
"""

from __future__ import annotations

import torch

from icikit_torch.ops import _build

LAUNCHES = {"segment_checksum": 0}
MASK32 = 0xFFFFFFFF
# the integer view of an element of each width (a bool is its byte)
INT_OF_WIDTH = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lanes(x2: torch.Tensor) -> torch.Tensor:
    """(p, n) elements -> their uint32 lanes as int64 in [0, 2^32): the
    bits zero-extended (a bool as its uint8 byte), 8-byte elements
    folded high ^ low."""
    w = x2.element_size()
    if w not in INT_OF_WIDTH:
        raise ValueError(f"segment_checksum: no integer view of {x2.dtype}")
    v = x2.view(INT_OF_WIDTH[w]).to(torch.int64)
    if w == 8:
        v = (v >> 32) ^ v
    return v & (0xFFFF if w == 2 else MASK32)


def _as_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) -> int32 with the same 32 bits."""
    return (v - ((v >> 31) << 32)).to(torch.int32)


def segment_checksum_plain(x: torch.Tensor) -> torch.Tensor:
    """(p, ...) -> (p,) int32: the uint32 bits of each row's fold, XOR
    over i of rotl(lane(x[r].flatten()[i]), i % 32)."""
    p = x.shape[0]
    u = _lanes(x.contiguous().view(p, -1) if p else x.reshape(0, 0))
    n = u.shape[1]
    if n == 0:
        return torch.zeros(p, dtype=torch.int32, device=x.device)
    s = torch.arange(n, device=x.device) % 32
    r = ((u << s) | (u >> ((32 - s) & 31))) & MASK32
    m = 1 << (n - 1).bit_length()
    if m != n:
        r = torch.nn.functional.pad(r, (0, m - n))
    while r.shape[1] > 1:
        h = r.shape[1] // 2
        r = r[:, :h] ^ r[:, h:]
    return _as_i32(r[:, 0])


_ENTRY: list = []   # the C entry, bound at first use


def _entry():
    if not _ENTRY:
        _ENTRY.append(_build.load("integrity").icikit_segment_checksum)
    return _ENTRY[0]


def segment_checksum(x: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """(p, ...) -> (p,) int32, the uint32 bits of each rank row's fold
    (JAX's ``segment_checksum`` of that rank's block). Bound: bytes,
    ``x`` read once. A CPU tensor, or ``plain=True``, takes
    :func:`segment_checksum_plain`; a CUDA tensor launches the kernel."""
    if x.dim() < 1:
        raise ValueError("segment_checksum takes a (p, ...) tensor")
    if plain or x.device.type == "cpu":
        return segment_checksum_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"segment_checksum: expected a CUDA or CPU "
                         f"tensor, got {x.device}")
    width = x.element_size()
    if width not in INT_OF_WIDTH:
        raise ValueError(f"segment_checksum: no integer view of {x.dtype}")
    x = x.contiguous()
    p = x.shape[0]
    n = x.numel() // p if p else 0
    out = torch.empty(p, dtype=torch.int32, device=x.device)
    rc = _entry()(x.data_ptr(), out.data_ptr(), p, n, width,
                  _build.sm_count(x.device), _build.stream(x))
    _build.check(rc, "segment_checksum launch")
    if p and n:
        LAUNCHES["segment_checksum"] += 1
    return out
