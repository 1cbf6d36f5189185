"""Carry state between the JAX package and the port, through numpy.

The sort path's state is the keys, the decode path's the weights, the
train path's the weights and the optimizer state. ``from_jax`` takes
the numpy array of a JAX array (``np.asarray(jax_array)``) and returns
a torch tensor of the same dtype and values; ``to_jax`` returns a numpy
array that ``jnp.asarray`` takes back; ``params_from_jax`` carries a
transformer's parameter dict and ``opt_state_from_jax`` a
``FusedAdam`` state.
Every dtype is kept. bfloat16 is the trap: its numpy dtype is
``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses, so it
travels as its uint16 bits.
"""

from __future__ import annotations

import numpy as np
import torch


def from_jax(a, device: str = "cpu") -> torch.Tensor:
    """numpy (or JAX) array -> torch tensor with the same dtype."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        t = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(device)


def to_jax(t: torch.Tensor) -> np.ndarray:
    """torch tensor -> numpy array with the same dtype (bf16 as
    ``ml_dtypes.bfloat16``, which ``jnp.asarray`` reads)."""
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_jax(params_np: dict, device: str = "cuda") -> dict:
    """The port's transformer parameters from the numpy arrays of
    ``icikit.models.transformer.init_params``'s leaves
    (``{name: np.asarray(leaf)}``): the same names, layouts and dtypes
    (``emb (V, D)``, ``pos (max_seq, D)``, ``ln1``/``ln2 (L, D)``,
    ``ln_f (D,)``, ``wqkv (L, D, 3, H, Dh)``, ``wo (L, H, Dh, D)``,
    ``w1 (L, D, F)``, ``w2 (L, F, D)``, ``w_out (V, D)``), on
    ``device``."""
    return {name: from_jax(a, device) for name, a in params_np.items()}


def opt_state_from_jax(state_np, device: str = "cuda"):
    """The port's ``FusedAdam`` state ``(m, v, t)`` from the numpy arrays
    of JAX's ``FusedAdam`` state (``({name: m}, {name: v}, t)``): moment
    dicts in their storage dtypes and the step count as a 0-d int32
    tensor, on ``device``."""
    m, v, t = state_np
    return (params_from_jax(m, device), params_from_jax(v, device),
            from_jax(np.asarray(t, dtype=np.int32), device).reshape(()))
