"""The two-pass flash backward (B8) against the JAX package's, on the CPU.

JAX runs ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` when the backward's
whole-sequence dq scratch would pass ``_DQ_SCRATCH_BYTES_MAX``; both
packages read that budget at call time, so the tests lower it to 0 in
each and compare the gradients (JAX's Pallas kernels in interpret mode,
the port's plain versions of ``flash_bwd_dq``/``flash_bwd_dkv``). The
same numpy inputs, made from a seed, go to both.

Tolerances, of the reference's largest magnitude: float32 1e-5 (float32
sums of up to s terms in other orders); bf16 2e-2 (both round P and dS
to bf16 before their products, against forward statistics that differ in
the last float32 bits, so an entry near a rounding boundary may land one
bf16 ulp, 2^-8 relative, the other way).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icikit.ops import flash_attention as jfa
from icikit_torch.interop import from_jax, to_jax
from icikit_torch.ops import cuda_attention
from icikit_torch.ops import flash_attention as tfa

CASES = [(shape, causal, dtype)
         for shape in ((1, 2048, 1, 64), (1, 2048, 2, 128))
         for causal in (True, False)
         for dtype in ("float32", "bfloat16")]


def _inputs(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]
    b, s, h, _ = shape
    g_lse = rng.standard_normal((b, h, s)).astype(np.float32)
    if dtype == "bfloat16":
        arrs = [np.asarray(jnp.asarray(a).astype(jnp.bfloat16))
                for a in arrs]
    return (*arrs, g_lse)


@pytest.fixture
def two_pass(monkeypatch):
    """Both packages' dq scratch budget at 0, and a count of the port's
    two-pass calls (the CPU route runs their plain versions)."""
    monkeypatch.setattr(jfa, "_DQ_SCRATCH_BYTES_MAX", 0)
    monkeypatch.setattr(tfa, "_DQ_SCRATCH_BYTES_MAX", 0)
    calls = {"dq": 0, "dkv": 0, "fused": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(cuda_attention, "flash_bwd_dq",
                        spy("dq", cuda_attention.flash_bwd_dq))
    monkeypatch.setattr(cuda_attention, "flash_bwd_dkv",
                        spy("dkv", cuda_attention.flash_bwd_dkv))
    monkeypatch.setattr(cuda_attention, "flash_bwd",
                        spy("fused", cuda_attention.flash_bwd))
    return calls


@pytest.mark.parametrize("shape,causal,dtype", CASES)
def test_two_pass_gradients_match_jax(shape, causal, dtype, two_pass):
    q, k, v, g_out, g_lse = _inputs(sum(shape) + causal, shape, dtype)

    def f(q, k, v):
        return jfa.flash_attention_with_lse(q, k, v, causal=causal)

    (jo, jl), vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    want = [np.asarray(a).astype(np.float32)
            for a in (jo, jl, *vjp((jnp.asarray(g_out),
                                    jnp.asarray(g_lse))))]
    ts = [from_jax(a).requires_grad_(True) for a in (q, k, v)]
    o, l = tfa.flash_attention_with_lse(*ts, causal=causal)
    torch.autograd.backward((o, l), (from_jax(g_out), from_jax(g_lse)))
    got = [to_jax(a.detach()).astype(np.float32)
           for a in (o, l, *(t.grad for t in ts))]
    assert two_pass == {"dq": 1, "dkv": 1, "fused": 0}
    assert [t.grad.dtype for t in ts] == [ts[0].dtype] * 3
    rel = 1e-5 if dtype == "float32" else 2e-2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=rel * max(np.abs(w).max(), 1.0))


@pytest.mark.parametrize("s,two", [(98304, False), (98305, True),
                                   (1024, False), (131072, True)])
def test_route_at_the_default_budget_matches_jax(s, two):
    """At d = 128 the 48 MiB budget holds s = 98304 rows of float32 dq:
    one row more takes the two-pass kernels, in both packages. Decided
    by the routing rule, nothing run."""
    d = 128
    assert tfa._DQ_SCRATCH_BYTES_MAX == jfa._DQ_SCRATCH_BYTES_MAX
    assert tfa.bwd_two_pass(s, d) is two
    assert (s * d * 4 > jfa._DQ_SCRATCH_BYTES_MAX) is two


def test_chunked_plain_versions_equal_the_whole_matrix():
    """The plain versions walked in Q-row chunks (the long-context
    oracle's form) equal the one-chunk form to float32 rounding, forward
    and both backward halves, causal and full."""
    rng = np.random.default_rng(5)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (1, 2, 200, 32)).astype(np.float32)) for _ in range(4))
    for causal in (True, False):
        out, lse = cuda_attention.flash_fwd_plain(q, k, v, causal, 0.2)
        c_out, c_lse = cuda_attention.flash_fwd_plain(q, k, v, causal, 0.2,
                                                      chunk=64)
        torch.testing.assert_close(c_out, out, atol=1e-6, rtol=0)
        torch.testing.assert_close(c_lse, lse, atol=1e-6, rtol=0)
        delta = (do * out).sum(-1)
        want = cuda_attention.flash_bwd_plain(q, k, v, do, lse, delta,
                                              causal, 0.2)
        got = (cuda_attention.flash_bwd_dq_plain(q, k, v, do, lse, delta,
                                                 causal, 0.2, chunk=48),
               *cuda_attention.flash_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                   causal, 0.2, chunk=48))
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
