"""The port's fused cross-entropy head against the JAX package's, on the
CPU.

The same numpy inputs, made from a seed, go through JAX's ``fused_xent``
(saved exponentials, fused backward, Pallas kernels in interpret mode
with ``block_t = block_v = 128`` so that it walks several chunks each
way) and the port's (its kernels' plain versions, the CPU tensors'
route). Tolerances: float32 nll 1e-5 and dx, dw 1e-5 of their largest
entry (float32 sums over V or T in other orders, and the port's
per-chunk maxima in place of JAX's running ones); bf16 nll 2e-2 and
dx, dw 2e-2 of their largest entry (e is stored in bf16 by both, but
against other maxima, and the two frameworks round the bf16 logits'
inputs alike while their float32 sums differ in order).

The four flavours (save_exp x fused_bwd) go through JAX's
``fused_xent`` at ``block_t=256, block_v=512``, as
``tests/test_xent.py`` drives them, with the same tolerances; the
matmul flavour in bf16 rounds g to bf16 in both before its products.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icikit.ops import xent as jx
from icikit_torch.interop import from_jax, to_jax
from icikit_torch.ops import cuda_xent
from icikit_torch.ops import xent as tx


def _inputs(seed, t, d, v, dtype):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d)).astype(np.float32)
    w = (rng.standard_normal((v, d)) / np.sqrt(d)).astype(np.float32)
    tg = rng.integers(0, v, (t,)).astype(np.int32)
    g = rng.standard_normal((t,)).astype(np.float32)
    if dtype == "bfloat16":
        x, w = (np.asarray(jnp.asarray(a).astype(jnp.bfloat16))
                for a in (x, w))
    return x, w, tg, g


def _jax(x, w, tg, g):
    def f(x, w):
        return jx.fused_xent(x, w, jnp.asarray(tg), block_t=128,
                             block_v=128, save_exp=True)

    nll, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(g))
    return [np.asarray(a).astype(np.float32) for a in (nll, dx, dw)]


def _port(x, w, tg, g):
    xt, wt = (from_jax(a).requires_grad_(True) for a in (x, w))
    nll = tx.fused_xent(xt, wt, from_jax(tg), block_t=128, block_v=128,
                        save_exp=True)
    nll.backward(from_jax(g))
    assert xt.grad.dtype == xt.dtype and wt.grad.dtype == wt.dtype
    return [to_jax(a).astype(np.float32) for a in (nll, xt.grad, wt.grad)]


def _close(got, want, nll_tol, rel):
    np.testing.assert_allclose(got[0], want[0], atol=nll_tol, rtol=0)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=rel * np.abs(b).max())


@pytest.mark.parametrize("t,v", [(256, 512), (128, 384), (384, 128)])
def test_fused_xent_matches_jax_float32(t, v):
    x, w, tg, g = _inputs(t + v, t, 128, v, "float32")
    cuda_xent.reset_launches()
    got = _port(x, w, tg, g)
    assert set(cuda_xent.LAUNCHES.values()) == {0}  # CPU: plain
    _close(got, _jax(x, w, tg, g), 1e-5, 1e-5)


def test_fused_xent_matches_jax_bfloat16():
    x, w, tg, g = _inputs(5, 256, 128, 512, "bfloat16")
    _close(_port(x, w, tg, g), _jax(x, w, tg, g), 2e-2, 2e-2)


def test_fused_xent_matches_the_unfused_head():
    """The fused head against log_softmax of the float32 logits (the
    oracle the JAX suite holds its head to)."""
    x, w, tg, g = _inputs(9, 128, 256, 640, "float32")
    got = _port(x, w, tg, g)
    xt, wt = (from_jax(a).requires_grad_(True) for a in (x, w))
    logp = torch.log_softmax(xt @ wt.t(), dim=-1)
    nll = -logp.gather(1, from_jax(tg).long()[:, None])[:, 0]
    nll.backward(from_jax(g))
    want = [to_jax(a) for a in (nll, xt.grad, wt.grad)]
    _close(got, want, 1e-5, 1e-5)


def test_plain_residual_rebuilds_the_softmax_at_any_chunk_width():
    """p = e exp2(m_i - lse log2 e) is the softmax whatever the chunk
    width the forward took its maxima over (the card's kernels use 128
    or 64 columns, a ragged last chunk included)."""
    x, w, tg, _ = _inputs(11, 64, 128, 200, "float32")
    xt, wt, tt = from_jax(x), from_jax(w), from_jax(tg)
    want = torch.softmax(xt @ wt.t(), dim=-1)
    for chunk in (64, 128, 200, 256):
        lse, tgt, e, mrun = cuda_xent.xent_fwd_plain(xt, wt, tt, True,
                                                     chunk)
        assert mrun.shape == (-(-200 // chunk), 64)
        p = e * cuda_xent._row_scale(mrun, lse, chunk, 200)
        torch.testing.assert_close(p, want, atol=1e-6, rtol=1e-5)
        torch.testing.assert_close(lse - tgt, torch.nn.functional.
                                   cross_entropy(xt @ wt.t(), tt.long(),
                                                 reduction="none"),
                                   atol=1e-5, rtol=0)


# (T, D, V, dtype): JAX's gate decides on its default blocks
GATE_CASES = [(8192, 1024, 32768, "bfloat16"), (64, 128, 256, "float32"),
              (1000, 128, 512, "float32"), (2048, 128, 3000, "bfloat16"),
              (2048, 96, 4096, "float32"), (100, 128, 61, "float32"),
              (64, 128, 256, "float16"), (3072, 256, 2048, "bfloat16"),
              (1536, 128, 2048, "float32")]


@pytest.mark.parametrize("t,d,v,dtype", GATE_CASES)
def test_gate_agrees_with_jax(t, d, v, dtype):
    tdt = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}[dtype]
    assert tx.xent_supported(t, d, v, tdt) == jx.xent_supported(
        t, d, v, jnp.dtype(dtype))


def test_unsupported_shapes_and_dtypes_raise():
    x = torch.zeros((8, 96))
    with pytest.raises(ValueError, match="D % 128"):
        tx.fused_xent(x, torch.zeros((16, 96)), torch.zeros(8).int(),
                      save_exp=True)
    with pytest.raises(ValueError, match="dtype mismatch"):
        tx.fused_xent(torch.zeros((8, 128)),
                      torch.zeros((16, 128), dtype=torch.bfloat16),
                      torch.zeros(8).int(), save_exp=True)


def _flavour(x, w, tg, g, save, fuse, port):
    if port:
        xt, wt = (from_jax(a).requires_grad_(True) for a in (x, w))
        nll = tx.fused_xent(xt, wt, from_jax(tg), block_t=256, block_v=512,
                            save_exp=save, fused_bwd=fuse)
        nll.backward(from_jax(g))
        assert xt.grad.dtype == xt.dtype and wt.grad.dtype == wt.dtype
        return [to_jax(a.detach()).astype(np.float32)
                for a in (nll, xt.grad, wt.grad)]

    def f(x, w):
        return jx.fused_xent(x, w, jnp.asarray(tg), block_t=256,
                             block_v=512, save_exp=save, fused_bwd=fuse)

    nll, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w))
    return [np.asarray(a).astype(np.float32)
            for a in (nll, *vjp(jnp.asarray(g)))]


@pytest.mark.parametrize("save", [True, False])
@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_flavours_match_jax(save, fuse, dtype):
    """Each of the four backward flavours (B10 saved and recompute, B11
    saved and recompute) against JAX's: loss, dx and dw."""
    x, w, tg, g = _inputs(17 + save + 2 * fuse, 512, 128, 1024, dtype)
    cuda_xent.reset_launches()
    got = _flavour(x, w, tg, g, save, fuse, port=True)
    assert set(cuda_xent.LAUNCHES.values()) == {0}  # CPU: plain
    tol = 1e-5 if dtype == "float32" else 2e-2
    _close(got, _flavour(x, w, tg, g, save, fuse, port=False), tol, tol)


def test_head_flavours_agree_with_each_other():
    """The four flavours compute one gradient: at float32 the port's
    saved and recompute, fused and matmul backwards agree to 1e-6 of the
    largest entry (float32 sums in other orders)."""
    x, w, tg, g = _inputs(23, 256, 128, 512, "float32")
    runs = [_flavour(x, w, tg, g, save, fuse, port=True)
            for save in (True, False) for fuse in (True, False)]
    for other in runs[1:]:
        _close(other, runs[0], 1e-6, 1e-6)
