"""The port's attention ops against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through both packages. JAX
runs its Pallas kernels in interpret mode, as its own tests do; the
port runs its kernels' plain versions (the CPU tensors' route).

Tolerances: forward float32 out and lse 1e-5; bf16 out 2e-2 (one bf16
ulp near 2, where both round P and out to bf16 against different row
maxima) and lse 1e-3; gradients at float32 1e-5 of the largest entry
(two float32 sums of up to s terms in other orders); the constant-shift
forward 1e-5 (the same float32 products, offset by the shift); the
overflow case against JAX 3e-4 of the largest entry (its logits reach
~400 nats, where one float32 ulp of the lse, 3e-5, moves P by as much
relative, and both sum in other orders), and against the port's own
online path 1e-6; decode step float32 out 1e-5 and the
written cache columns bitwise; RoPE 1e-6.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icikit.ops import flash_attention as jfa
from icikit.ops.rope import apply_rope as j_apply_rope
from icikit.ops.rope import rope_sincos as j_rope_sincos
from icikit_torch.interop import from_jax, to_jax
from icikit_torch.ops import cuda_attention
from icikit_torch.ops import flash_attention as tfa
from icikit_torch.ops.rope import apply_rope, rope_sincos


def _inputs(seed, shapes, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    if dtype == "bfloat16":
        arrs = [np.asarray(jnp.asarray(a).astype(jnp.bfloat16))
                for a in arrs]
    return arrs


# (s, causal, d, block_k given to JAX so it takes B3's multi-block
# route; None leaves JAX's own choice: one block, B5, at s = 64)
FWD_CASES = [(s, causal, d, bk)
             for s, bk in ((64, None), (96, None), (256, 64))
             for causal in (True, False) for d in (32, 128)]


@pytest.mark.parametrize("s,causal,d,block_k", FWD_CASES)
def test_flash_forward_matches_jax_float32(s, causal, d, block_k):
    q, k, v = _inputs(s * d + causal, [(2, s, 2, d)] * 3, "float32")
    want_o, want_l = jfa.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_k=block_k)
    cuda_attention.reset_launches()
    got_o, got_l = tfa.flash_attention_with_lse(
        from_jax(q), from_jax(k), from_jax(v), causal=causal)
    assert cuda_attention.LAUNCHES["flash_fwd"] == 0  # CPU: plain version
    np.testing.assert_allclose(to_jax(got_o), np.asarray(want_o), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(to_jax(got_l), np.asarray(want_l), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("s,causal,d,block_k", [(256, True, 128, 64),
                                                (96, False, 32, None),
                                                (64, True, 128, None)])
def test_flash_forward_matches_jax_bfloat16(s, causal, d, block_k):
    q, k, v = _inputs(7 + s, [(2, s, 2, d)] * 3, "bfloat16")
    want_o, want_l = jfa.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_k=block_k)
    got_o, got_l = tfa.flash_attention_with_lse(
        from_jax(q), from_jax(k), from_jax(v), causal=causal)
    assert got_o.dtype == torch.bfloat16
    np.testing.assert_allclose(to_jax(got_o).astype(np.float32),
                               np.asarray(want_o).astype(np.float32),
                               atol=2e-2, rtol=0)
    np.testing.assert_allclose(to_jax(got_l), np.asarray(want_l), atol=1e-3,
                               rtol=0)


def test_dense_fallback_for_causal_cross_lengths():
    """causal with s_q != s_kv is the one shape both packages send to
    the dense oracle (end-aligned mask)."""
    q, = _inputs(3, [(1, 8, 2, 32)], "float32")
    k, v = _inputs(4, [(1, 24, 2, 32)] * 2, "float32")
    want_o, want_l = jfa.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    got_o, got_l = tfa.flash_attention_with_lse(
        from_jax(q), from_jax(k), from_jax(v), causal=True)
    np.testing.assert_allclose(to_jax(got_o), np.asarray(want_o), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(to_jax(got_l), np.asarray(want_l), atol=1e-5,
                               rtol=0)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True)
    got = tfa.flash_attention(from_jax(q), from_jax(k), from_jax(v),
                              causal=True)
    np.testing.assert_allclose(to_jax(got), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_unported_options_refuse_loudly():
    """What this slice leaves unported raises, naming its ROADMAP row:
    the recompute-flavour fused head and the matmul head backward (B10
    recompute, B11), the one-pass Adam kernel (B12) and the remat
    policies other than nothing and except_attn."""
    from icikit_torch.models.transformer import (TransformerConfig,
                                                 make_model_mesh,
                                                 make_train_step)
    from icikit_torch.ops.adam import adam_apply
    from icikit_torch.ops.xent import fused_xent

    x = torch.zeros((8, 128))
    w = torch.zeros((16, 128))
    t = torch.zeros((8,), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="B10, recompute"):
        fused_xent(x, w, t, save_exp=False)
    with pytest.raises(NotImplementedError, match="B11"):
        fused_xent(x, w, t, save_exp=True, fused_bwd=False)
    p = {"a": torch.zeros(4)}
    with pytest.raises(NotImplementedError, match="B12"):
        adam_apply(p, p, p, p, 1e-3, 1, use_pallas=True)
    mesh = make_model_mesh(device="cpu")
    with pytest.raises(NotImplementedError, match="remat_policy='dots'"):
        make_train_step(mesh, TransformerConfig(remat_policy="dots"))
    with pytest.raises(ValueError, match="unknown attention impl"):
        tfa.resolve_attention_impl("ring")


@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("cur", [0, 5, 15])
def test_decode_step_matches_jax(rope, cur):
    """The port's decode step (plain on the CPU) against JAX's
    ``decode_step_attention`` called directly, outside shard_map."""
    rows, total, dh = 6, 16, 128
    q, k, v = _inputs(cur + 10 * rope, [(rows, dh)] * 3, "float32")
    kc, vc = _inputs(99, [(rows, total, dh)] * 2, "float32")
    c, s = j_rope_sincos(jnp.asarray([cur]), dh, 10000.0)
    cos2 = np.asarray(jnp.concatenate([c, c], -1))
    sin2 = np.asarray(jnp.concatenate([s, s], -1))
    scale = dh ** -0.5
    want, want_kc, want_vc = jfa.decode_step_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kc),
        jnp.asarray(vc), jnp.int32(cur), jnp.asarray(cos2),
        jnp.asarray(sin2), scale=scale, rope=rope)
    t_kc, t_vc = from_jax(kc), from_jax(vc)
    got, got_kc, got_vc = tfa.decode_step_attention(
        from_jax(q), from_jax(k), from_jax(v), t_kc, t_vc, cur,
        from_jax(cos2), from_jax(sin2), scale=scale, rope=rope)
    assert got_kc is t_kc and got_vc is t_vc      # updated in place
    np.testing.assert_allclose(to_jax(got), np.asarray(want), atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(to_jax(t_kc), np.asarray(want_kc))
    np.testing.assert_array_equal(to_jax(t_vc), np.asarray(want_vc))


def test_decode_step_gate_and_cache_len():
    assert tfa.decode_step_supported(128, 1, torch.bfloat16)
    assert tfa.decode_step_supported(256, 1, torch.float32)
    assert not tfa.decode_step_supported(8, 1, torch.float32)
    assert not tfa.decode_step_supported(128, 2, torch.bfloat16)
    assert not tfa.decode_step_supported(128, 1, torch.float16)
    assert tfa.decode_step_cache_len(577, torch.bfloat16) == 577


@pytest.mark.parametrize("per_row", [False, True])
def test_apply_rope_matches_jax(per_row):
    x, = _inputs(5, [(2, 6, 3, 16)], "float32")
    pos = (np.array([[3, 4, 5, 6, 7, 8], [0, 1, 2, 9, 10, 11]])
           if per_row else np.arange(2, 8))
    want = j_apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = apply_rope(from_jax(x), torch.from_numpy(pos), 10000.0)
    np.testing.assert_allclose(to_jax(got), np.asarray(want), atol=1e-6,
                               rtol=0)
    jc, js = j_rope_sincos(jnp.asarray(pos), 16, 500.0)
    tc, ts = rope_sincos(torch.from_numpy(pos), 16, 500.0)
    np.testing.assert_allclose(to_jax(tc), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(to_jax(ts), np.asarray(js), atol=1e-6)


def test_apply_rope_keeps_bfloat16():
    x, = _inputs(6, [(1, 4, 2, 8)], "bfloat16")
    want = j_apply_rope(jnp.asarray(x), jnp.arange(4))
    got = apply_rope(from_jax(x), torch.arange(4))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(to_jax(got).astype(np.float32),
                               np.asarray(want).astype(np.float32),
                               atol=1e-2, rtol=0)



# ------------------------------------------------------------- gradients


def _jax_grads(q, k, v, g_out, g_lse, causal, block, shift=None):
    """JAX's (out, lse) and the vjp of (q, k, v) under cotangents
    (g_out, g_lse)."""
    kw = dict(causal=causal, softmax_shift=shift)
    if block:
        kw.update(block_q=block, block_k=block)

    def f(q, k, v):
        return jfa.flash_attention_with_lse(q, k, v, **kw)

    (o, l), vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    grads = vjp((jnp.asarray(g_out), jnp.asarray(g_lse)))
    return [np.asarray(a) for a in (o, l, *grads)]


def _torch_grads(q, k, v, g_out, g_lse, causal, shift=None):
    ts = [from_jax(a).requires_grad_(True) for a in (q, k, v)]
    o, l = tfa.flash_attention_with_lse(*ts, causal=causal,
                                        softmax_shift=shift)
    torch.autograd.backward((o, l), (from_jax(g_out), from_jax(g_lse)))
    return [to_jax(a) for a in (o, l, *(t.grad for t in ts))]


def _close(got, want, rel):
    """Within ``rel`` of the reference's largest magnitude."""
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=rel * max(np.abs(w).max(), 1.0))


# (s, JAX block_q = block_k): one block (B6) and 2 x 2 blocks (B7)
GRAD_CASES = [(s, block, causal, d)
              for s, block in ((128, None), (256, 128))
              for causal in (True, False) for d in (32, 128)]


@pytest.mark.parametrize("s,block,causal,d", GRAD_CASES)
def test_flash_gradients_match_jax(s, block, causal, d):
    """dq, dk, dv with a non-zero lse cotangent against jax.vjp of JAX's
    custom_vjp, whose backward runs B6 (one block) or B7 (many)."""
    q, k, v, g_out = _inputs(s + d + causal, [(2, s, 2, d)] * 4, "float32")
    g_lse, = _inputs(s + 1, [(2, 2, s)], "float32")
    want = _jax_grads(q, k, v, g_out, g_lse, causal, block)
    cuda_attention.reset_launches()
    got = _torch_grads(q, k, v, g_out, g_lse, causal)
    assert cuda_attention.LAUNCHES == {"flash_fwd": 0, "flash_bwd": 0,
                                       "decode_step": 0}
    _close(got, want, 1e-5)


@pytest.mark.parametrize("s,block", [(128, None), (256, 128)])
def test_softmax_shift_matches_jax(s, block):
    """The constant-shift forward (B5's shift branch at one block, B4 at
    many): outputs, lse and gradients against JAX's."""
    q, k, v, g_out = _inputs(40 + s, [(1, s, 2, 64)] * 4, "float32")
    g_lse, = _inputs(41, [(1, 2, s)], "float32")
    want = _jax_grads(q, k, v, g_out, g_lse, True, block, shift=16.0)
    got = _torch_grads(q, k, v, g_out, g_lse, True, shift=16.0)
    _close(got, want, 1e-5)


def test_softmax_shift_overflow_falls_back_exactly():
    """q * 400 overflows exp2 around the shift: the lse stays finite and
    the gradients equal the online softmax's (and JAX's, whose traced
    cond re-runs the online kernel)."""
    q, k, v, g_out = _inputs(7, [(1, 256, 4, 64)] * 4, "float32")
    q = q * 400.0
    g_lse = np.zeros((1, 4, 256), np.float32)
    shifted = _torch_grads(q, k, v, g_out, g_lse, True, shift=16.0)
    online = _torch_grads(q, k, v, g_out, g_lse, True)
    assert np.isfinite(shifted[1]).all()
    assert all(np.isfinite(a).all() for a in shifted)
    _close(shifted, online, 1e-6)
    want = _jax_grads(q, k, v, g_out, g_lse, True, 128, shift=16.0)
    _close(shifted, want, 3e-4)
    # the plain version falls back row by row: mixed rows stay exact
    qm = np.concatenate([q[:, :128] / 400.0, q[:, 128:]], axis=1)
    got = _torch_grads(qm, k, v, g_out, g_lse, True, shift=16.0)
    _close(got, _torch_grads(qm, k, v, g_out, g_lse, True), 1e-5)


def test_flash_forward_under_no_grad_saves_nothing():
    """The decode path calls the forward under no_grad: no graph."""
    q, = _inputs(3, [(1, 64, 2, 32)], "float32")
    t = from_jax(q).requires_grad_(True)
    with torch.no_grad():
        out = tfa.flash_attention(t, t, t, causal=True, softmax_shift=16.0)
    assert out.grad_fn is None
