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
              (1536, 128, 2048, "float32"), (1024, 2176, 2048, "bfloat16"),
              (1024, 4096, 2048, "bfloat16")]


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


@pytest.mark.parametrize("v", [61, 257, 1001])
def test_bf16_ragged_vocab_gate_and_route_agree(v):
    """bf16 at a V that is not a multiple of 8, d 128: JAX's gate takes
    the fused head, the port's declines it (its bf16 kernels read
    16-byte rows of V), and every decision of the port agrees: the
    gate, the model's route and ``fused_xent``'s refusal, decided from
    shape and dtype alone, so the same on any device. float32 at the
    same V keeps JAX's decision."""
    from icikit_torch.models.transformer.model import (TransformerConfig,
                                                       _use_fused_head)

    t = 64
    assert jx.xent_supported(t, 128, v, jnp.bfloat16)
    assert not tx.xent_supported(t, 128, v, torch.bfloat16)
    assert tx.xent_supported(t, 128, v, torch.float32) == \
        jx.xent_supported(t, 128, v, jnp.float32)
    cfg = TransformerConfig(vocab=v, d_model=128, n_heads=4, d_head=32,
                            d_ff=256, n_layers=1, max_seq=32,
                            compute_dtype="bfloat16")
    assert not _use_fused_head(cfg, 2, 32)
    x, w, tg, _ = _inputs(v, t, 128, v, "bfloat16")
    with pytest.raises(ValueError, match="V % 8"):
        tx.fused_xent(from_jax(x), from_jax(w), from_jax(tg), save_exp=True)


def test_bf16_ragged_vocab_head_matches_jax():
    """The port's loss at bf16, V = 61, d_model 128 (its unfused head,
    the gate's route) against JAX's (its fused head, Pallas interpret
    mode), on JAX's weights and the same tokens: the loss within the
    file's bf16 2e-2 (relative) and the head weight's gradient within
    2e-2 of its largest entry."""
    from icikit.models.transformer import TransformerConfig as JConfig
    from icikit.models.transformer import init_params as j_init_params
    from icikit.models.transformer.model import loss_and_metrics as j_loss
    from icikit.models.transformer.model import make_model_mesh as j_mesh
    from icikit_torch.interop import params_from_jax
    from icikit_torch.models.transformer import (TransformerConfig,
                                                 loss_and_metrics,
                                                 make_model_mesh)

    cfg = dict(vocab=61, d_model=128, n_heads=4, d_head=32, d_ff=256,
               n_layers=1, max_seq=32, compute_dtype="bfloat16",
               remat_policy="except_attn")
    assert jx.xent_supported(64, 128, 61, jnp.bfloat16)
    mesh = j_mesh(dp=1, tp=1, sp=1)
    jparams = j_init_params(jax.random.key(7), JConfig(**cfg), mesh)
    rng = np.random.default_rng(7)
    tok, tgt = (rng.integers(0, 61, (2, 32)).astype(np.int32)
                for _ in range(2))
    jl, jg, _ = j_loss(jparams, jnp.asarray(tok), jnp.asarray(tgt), mesh,
                       JConfig(**cfg))
    tparams = params_from_jax({k: np.asarray(a) for k, a in jparams.items()},
                              "cpu")
    cuda_xent.reset_launches()
    tl, tgrads, _ = loss_and_metrics(tparams, torch.from_numpy(tok),
                                     torch.from_numpy(tgt),
                                     make_model_mesh(device="cpu"),
                                     TransformerConfig(**cfg))
    assert set(cuda_xent.LAUNCHES.values()) == {0}
    np.testing.assert_allclose(float(tl), float(jl), rtol=2e-2)
    got = to_jax(tgrads["w_out"]).astype(np.float32)
    want = np.asarray(jg["w_out"]).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-2 * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_recompute_flavour_past_one_cluster_matches_jax(dtype):
    """The recompute flavour (save_exp=False, fused_bwd=True) at D 2176,
    past the 2048 that one cluster of the bf16 recompute kernel covers
    (the card walks chunks there): loss, dx and dw against JAX's
    ``fused_xent`` at ``block_t=256, block_v=512`` with the file's
    tolerances (float32 1e-5, bf16 2e-2)."""
    x, w, tg, g = _inputs(29, 256, 2176, 512, dtype)
    assert 2176 > cuda_xent.CLUSTER_D_MAX
    cuda_xent.reset_launches()
    got = _flavour(x, w, tg, g, False, True, port=True)
    assert set(cuda_xent.LAUNCHES.values()) == {0}  # CPU: plain
    tol = 1e-5 if dtype == "float32" else 2e-2
    _close(got, _flavour(x, w, tg, g, False, True, port=False), tol, tol)


# (T, D, V, chunk): several chunks each way, the last one ragged
WALK_CASES = [(300, 136, 1000, 72), (256, 2176, 512, 72),
              (130, 64, 264, 16), (257, 128, 520, 128), (96, 64, 1000, 56)]


@pytest.mark.parametrize("t,d,v,chunk", WALK_CASES)
def test_recompute_walk_with_plain_pieces_matches_plain(t, d, v, chunk):
    """The walk past D 2048 (``recompute_walk``) with its pieces' plain
    versions (``g_cols_plain``, ``g_product_plain``) at chunk sizes that
    split T and V into several ragged chunks: dx and dw against
    ``xent_dx_plain`` / ``xent_dw_plain`` at float32 within 1e-5 of the
    largest entry (the same float32 sums, V or T cut into chunks)."""
    x, w, tg, _ = _inputs(t + v + chunk, t, d, v, "float32")
    xt, wt, tt = from_jax(x), from_jax(w), from_jax(tg)
    dn = torch.from_numpy(np.random.default_rng(chunk).standard_normal(t)
                          .astype(np.float32))
    lse, _ = cuda_xent.xent_fwd_plain(xt, wt, tt, False)
    for which, plain, rows in (("dx", cuda_xent.xent_dx_plain, t),
                               ("dw", cuda_xent.xent_dw_plain, v)):
        out = torch.full((rows, d), float("nan"))
        pieces = []  # the rows of each chunk's g
        cuda_xent.recompute_walk(
            which, xt, wt, tt, lse, dn, out, chunk,
            lambda *a: pieces.append(a[1].shape[0] if which == "dw"
                                     else a[0].shape[0])
            or cuda_xent.g_cols_plain(*a),
            cuda_xent.g_product_plain)
        assert sum(pieces) == rows and len(pieces) == -(-rows // chunk)
        assert len(pieces) > 1 and pieces[-1] != chunk
        want = plain(xt, wt, tt, lse, dn).numpy()
        np.testing.assert_allclose(out.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_g_cols_plain_is_a_slice_of_the_whole_g():
    """The walk's first piece on a vocabulary chunk v0:v1 is columns
    v0:v1 of g over the whole vocabulary: a target outside the chunk
    matches none of its columns, one inside matches at target - v0."""
    x, w, tg, _ = _inputs(31, 64, 128, 300, "float32")
    xt, wt, tt = from_jax(x), from_jax(w), from_jax(tg)
    tt[:8] = 5           # targets in the first chunk only
    dn = torch.ones(64)
    lse, _ = cuda_xent.xent_fwd_plain(xt, wt, tt, False)
    whole = cuda_xent.g_cols_plain(xt, wt, tt, lse, dn)
    assert (whole < 0).any()
    for v0, v1 in ((0, 96), (96, 192), (192, 300)):
        got = cuda_xent.g_cols_plain(xt, wt[v0:v1], tt, lse, dn, v0)
        torch.testing.assert_close(got, whole[:, v0:v1], atol=0, rtol=0)
        hit = (tt.long() >= v0) & (tt.long() < v1)
        assert bool((got.min(1).values < 0).eq(hit).all())


@pytest.mark.parametrize("n,d,sms,want", [
    (8192, 4096, 132, 1024), (32768, 4096, 132, 1024),
    (8192, 2176, 132, 1792), (1100, 4096, 132, 272), (4104, 4096, 132, 1024),
    (256, 8192, 132, 64), (520, 8192, 132, 128), (20, 8192, 132, 8),
    (8192, 40960, 132, 128), (32, 4096, 132, 8), (31, 4096, 132, 8),
    (8, 2176, 132, 8), (5, 2176, 132, 5)])
def test_recompute_chunk_fills_a_wave_within_a_quarter(n, d, sms, want):
    """A chunk of the walk is the 128-row tiles whose ceil(D / 256)
    slices fill one wave of the product kernel, at most a quarter of the
    rows (a multiple of 8), so that g's scratch (chunk rows of the other
    side, as ``walk_on_card`` takes it) stays within a quarter of the
    (T, V) bf16 residual: 64 MiB (dx) and 16 MiB (dw) at T 8192, D 4096,
    V 32768 on an H100's 132 SMs. Below 32 rows the chunk is 8 rows, or
    all of them when fewer: the scratch never outgrows 8 rows or n."""
    chunk = cuda_xent.recompute_chunk(n, d, sms)
    assert chunk == want and (chunk % 8 == 0 or chunk == n)
    other = 32768
    scratch, residual = chunk * other * 2, n * other * 2
    if n >= 32:
        assert 4 * scratch <= residual
    else:
        assert scratch <= min(8, n) * other * 2
    assert chunk * -(-d // 256) <= max(sms, -(-d // 256)) * 128
