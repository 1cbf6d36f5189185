"""The port's Adam against the JAX package's, on the CPU.

``adam_apply`` (the XLA formulation, ``use_pallas=False``, the one the
train step runs) from carried non-zero moments, over float32 and bf16
moment storage and float32 and bf16 gradients. Tolerances: params 1e-7
absolute at unit scale and moments bitwise for float32 storage (the same
float32 operations in the same order; XLA and torch agree to the last
bit here except where XLA fuses differently, which this arithmetic does
not invite); bf16 moments within one bf16 ulp (2^-8 relative), since a
float32 value one ulp either side of a rounding boundary may round the
other way in the other framework.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icikit.ops.adam import adam_apply as j_adam_apply
from icikit.ops.adam import adam_scalars as j_adam_scalars
from icikit_torch.interop import from_jax, opt_state_from_jax, to_jax
from icikit_torch.ops.adam import adam_apply, adam_scalars

SHAPES = {"w": (16, 24), "b": (24,), "s": (3, 4, 5)}


def _state(seed, mom_dtype, grad_dtype):
    rng = np.random.default_rng(seed)

    def arr(shape, scale=1.0, dtype=np.float32):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        return np.asarray(jnp.asarray(a).astype(dtype))

    p = {k: arr(s) for k, s in SHAPES.items()}
    m = {k: arr(s, 0.1, mom_dtype) for k, s in SHAPES.items()}
    v = {k: np.abs(arr(s, 0.01, mom_dtype)) for k, s in SHAPES.items()}
    g = {k: arr(s, 1.0, grad_dtype) for k, s in SHAPES.items()}
    return p, m, v, g


@pytest.mark.parametrize("mom_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step", [1, 7])
def test_adam_apply_matches_jax(mom_dtype, grad_dtype, step):
    p, m, v, g = _state(step, jnp.dtype(mom_dtype), jnp.dtype(grad_dtype))
    jp, jm, jv = j_adam_apply(
        {k: jnp.asarray(a) for k, a in p.items()},
        {k: jnp.asarray(a) for k, a in m.items()},
        {k: jnp.asarray(a) for k, a in v.items()},
        {k: jnp.asarray(a) for k, a in g.items()},
        3e-3, jnp.int32(step), use_pallas=False)
    tp = {k: from_jax(a) for k, a in p.items()}
    tm, tv, t = opt_state_from_jax((m, v, np.int32(step)), "cpu")
    assert t.dtype == torch.int32 and t.dim() == 0
    tg = {k: from_jax(a) for k, a in g.items()}
    ids = {k: a.data_ptr() for k, a in tp.items()}
    out_p, out_m, out_v = adam_apply(tp, tm, tv, tg, 3e-3, t)
    assert out_p is tp and {k: a.data_ptr() for k, a in tp.items()} == ids
    for k in SHAPES:
        assert tm[k].dtype == tv[k].dtype == torch.bfloat16 \
            if mom_dtype == "bfloat16" else tm[k].dtype == torch.float32
        np.testing.assert_allclose(to_jax(tp[k]), np.asarray(jp[k]),
                                   atol=1e-7, rtol=0)
        for got, want in ((tm[k], jm[k]), (tv[k], jv[k])):
            got, want = to_jax(got).astype(np.float32), \
                np.asarray(want).astype(np.float32)
            if mom_dtype == "float32":
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=0)


@pytest.mark.parametrize("step", [1, 2, 1000])
def test_adam_scalars_match_jax(step):
    got = adam_scalars(1e-4, torch.tensor(step, dtype=torch.int32))
    want = np.asarray(j_adam_scalars(1e-4, jnp.int32(step)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-7, atol=0)


def test_device_guard_select_commits_nothing():
    p, m, v, g = _state(3, jnp.float32, jnp.float32)
    tp = {k: from_jax(a) for k, a in p.items()}
    tm = {k: from_jax(a) for k, a in m.items()}
    tv = {k: from_jax(a) for k, a in v.items()}
    before = [{k: a.clone() for k, a in d.items()} for d in (tp, tm, tv)]
    adam_apply(tp, tm, tv, {k: from_jax(a) for k, a in g.items()}, 1e-3,
               1, ok=torch.tensor(False))
    for d, b in zip((tp, tm, tv), before):
        assert all(torch.equal(d[k], b[k]) for k in SHAPES)
