"""JAX's threefry2x32 PRNG, bit for bit, in torch.

The port of the draws ``icikit/models/transformer/decode.py`` keys by
``jax.random``: the default ``threefry2x32`` implementation with JAX's
default flags (32-bit mode, ``jax_threefry_partitionable=True``, the
"low" Gumbel mode). Threefry is only 32-bit adds, rotates and xors, so
these functions reproduce JAX's key data and bits exactly, on any
device. torch has no full uint32 arithmetic: every word rides an int64
tensor holding a value in ``[0, 2^32)``, masked after each add.

- :func:`threefry2x32`: 20 rounds with rotations (13, 15, 26, 6) and
  (17, 29, 16, 24), a key injection after every four, the key
  schedule's third word ``k1 ^ k2 ^ 0x1BD11BDA``.
- :func:`key_data`: ``jax.random.key_data(jax.random.key(seed))``.
- :func:`fold_in`: the data split into (hi, lo) words, hi 0 for 32-bit
  data (negative int32 data taken mod 2^32, as ``jnp.asarray(data,
  "uint32")`` does).
- :func:`random_bits`: 32-bit draws in the partitionable layout: the
  counts are each flat index's (hi, lo) words and the bits the xor of
  the two output words.
- :func:`uniform`, :func:`gumbel`, :func:`categorical`: float32 draws
  as ``jax.random``'s. The key data and the uniforms are bitwise JAX's;
  the Gumbel draws go through torch's ``log``, which rounds otherwise
  than XLA's in the last place, so a categorical draw can differ from
  JAX's only at a near-tie of its argmax.

Key data are ``(..., 2)`` int64 tensors; :func:`as_key_data` takes
JAX's ``(2,)`` uint32 arrays (numpy or torch).
"""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# float32's smallest normal number (``jnp.finfo(float32).tiny``)
_TINY = float(np.finfo(np.float32).tiny)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash of the count words ``(x1, x2)`` under the
    key ``(k1, k2)``: int64 tensors (or ints) of uint32 values that
    broadcast together; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = x1 ^ _rotl(x2, r)
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def as_key_data(key, device=None) -> torch.Tensor:
    """JAX key data (a ``(..., 2)`` uint32 numpy array or torch tensor,
    or this module's int64 form) as this module's int64 tensor."""
    if isinstance(key, torch.Tensor):
        t = key.to(torch.int64) if key.dtype != torch.int64 else key
        t = t & MASK
    else:
        t = torch.from_numpy(np.asarray(key).astype(np.uint32)
                             .astype(np.int64))
    if t.shape[-1:] != (2,):
        raise ValueError(f"key data must end in a dim of 2, got "
                         f"{tuple(t.shape)}")
    return t if device is None else t.to(device)


def to_numpy(key: torch.Tensor) -> np.ndarray:
    """This module's key data as JAX's uint32 numpy form."""
    return key.cpu().numpy().astype(np.uint32)


def key_data(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.key_data(jax.random.key(seed))`` in 32-bit mode: the
    seed taken mod 2^32 as the low word, the high word 0."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` of 32-bit ``data`` into ``key``, batched:
    ``key (..., 2)`` and integer ``data`` broadcast together."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & MASK
    o1, o2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack(torch.broadcast_tensors(o1, o2), dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32-bit ``jax.random.bits(key, shape)`` for each key of ``key
    (..., 2)``: int64 of uint32 values, ``key.shape[:-1] + shape``."""
    shape = tuple(shape)
    n = int(np.prod(shape, dtype=np.int64))
    idx = torch.arange(n, device=key.device, dtype=torch.int64)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(*lead, *(1,) * len(shape))
    k2 = key[..., 1].reshape(*lead, *(1,) * len(shape))
    o1, o2 = threefry2x32(k1, k2, (idx >> 32).reshape(shape),
                          (idx & MASK).reshape(shape))
    return o1 ^ o2


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 ``jax.random.uniform(key, shape, minval=, maxval=)``: the
    bits' top 23 as a mantissa in [1, 2), less 1, scaled, and held at
    ``minval`` or above, every step rounded as JAX's."""
    bits = random_bits(key, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    f = f - 1.0
    # the bounds as float32 scalars, never tensors copied to the device
    lo = np.float32(minval)
    scale = float(np.float32(maxval) - lo)
    return torch.clamp_min(f * scale + float(lo), float(lo))


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """float32 ``jax.random.gumbel(key, shape)`` in its "low" mode:
    ``-log(-log(u))`` of a uniform in [tiny, 1)."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` for each row: ``key
    (..., 2)`` against float32 ``logits (..., V)``, the argmax of a row's
    Gumbel draws plus its logits (the first index on a tie); int64."""
    g = gumbel(key, logits.shape[-1:])
    return torch.argmax(g + logits, dim=-1)
