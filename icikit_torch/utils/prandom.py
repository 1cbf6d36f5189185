"""Deterministic, partition-invariant input generation.

The reference guarantees the same global random sequence whatever p is
by chaining an ``erand48`` seed through the ranks in turn
(``Parallel-Sorting/src/psort.cc:575-614``). The JAX package gets the
same property from threefry's counter-based bits. The port's threefry
(``utils/threefry.py``, JAX's bits, for sampled decode) costs some 170
elementwise launches a call, so the sort's inputs keep a generator of
their own (its bits are not JAX's):

- ``uniform_global`` makes the whole sequence from one explicit CPU
  ``torch.Generator`` seeded with ``seed`` and moves it to the device:
  every partition of it is a slice of one tensor, so it is p-invariant
  by construction, and the same on every device.
- ``uniform_block`` makes any block of a sequence without the rest: each
  element is a hash (splitmix64) of (seed, global index) on int64
  tensors, so a block equals the same slice of the whole sequence bit
  for bit, and its draws are the same on the CPU and the card (the
  odd_dist skew then follows the device's float32 ``pow``).

``odd_dist_warp`` is the reference's skewed ``ODD_DIST`` distribution
(``psort.cc:598-609``): ``val = (val ** (1 + 3*i/n)) ** 2`` with i the
global element index, the formula of ``icikit.utils.prandom``.
"""

from __future__ import annotations

import torch

# splitmix64's constants as signed int64 (torch has no uint64 arithmetic;
# int64 products wrap as uint64 ones do)
_GAMMA = 0x9E3779B97F4A7C15 - (1 << 64)
_MIX1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_MIX2 = 0x94D049BB133111EB - (1 << 64)


def _shr(z: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 ``z`` by ``k`` bits."""
    return (z >> k) & ((1 << (64 - k)) - 1)


def _splitmix64(z: torch.Tensor) -> torch.Tensor:
    z = (z ^ _shr(z, 30)) * _MIX1
    z = (z ^ _shr(z, 27)) * _MIX2
    return z ^ _shr(z, 31)


def odd_dist_warp(vals: torch.Tensor, global_offset: int = 0,
                  global_n: int | None = None) -> torch.Tensor:
    """Apply the reference's position-dependent skew to uniform(0, 1)
    draws. ``vals`` is the whole sequence (default) or a block of it at
    ``global_offset`` in a sequence of ``global_n``
    (``psort.cc:600-609``)."""
    if global_n is None:
        global_n = vals.numel()
    i = (torch.arange(vals.numel(), device=vals.device).to(vals.dtype)
         .reshape(vals.shape) + global_offset)
    exponent = 1.0 + 3.0 * i / global_n
    return torch.pow(vals, exponent) ** 2


def uniform_global(seed: int, n: int, dtype=torch.float32,
                   odd_dist: bool = False,
                   device: str = "cuda") -> torch.Tensor:
    """The global input sequence of n uniform(0, 1) draws, identical for
    every partitioning and every device: one CPU ``torch.Generator``
    seeded with ``seed`` makes it in float32, skewed on the CPU where
    ``odd_dist`` asks, before the move to ``device`` and the cast to
    ``dtype``."""
    gen = torch.Generator().manual_seed(seed)
    vals = torch.rand(n, generator=gen, dtype=torch.float32)
    if odd_dist:
        vals = odd_dist_warp(vals)
    return vals.to(device).to(dtype)


def uniform_block(seed: int, n: int, start: int, block: int,
                  dtype=torch.float32, odd_dist: bool = False,
                  device: str = "cuda") -> torch.Tensor:
    """Elements [start, start + block) of the length-n sequence of
    uniform(0, 1) draws keyed by ``seed``, without making the rest: the
    draw at global index i is the top 24 bits of splitmix64(seed' + (i +
    1) * gamma) over 2^24, seed' = splitmix64(seed). Any block equals
    the same slice of ``uniform_block(seed, n, 0, n)`` bit for bit, on
    any device. Its sequence is not ``uniform_global``'s."""
    base = _splitmix64(torch.tensor(seed, dtype=torch.int64))
    idx = torch.arange(start + 1, start + block + 1, dtype=torch.int64,
                       device=device)
    z = _splitmix64(base.to(device) + idx * _GAMMA)
    vals = _shr(z, 40).to(torch.float32) * (1.0 / (1 << 24))
    if odd_dist:
        vals = odd_dist_warp(vals, global_offset=start, global_n=n)
    return vals.to(dtype)
