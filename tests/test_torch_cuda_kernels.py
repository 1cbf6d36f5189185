"""icikit_torch's CUDA kernels against their plain versions, on the card.

The kernels have no CPU mode, so every test here skips without a CUDA
device. This file imports neither jax nor icikit, so it also runs where
only the port is installed:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py

Tolerance: exact for the sort kernels (integers bitwise, floats by
value); the attention and cross-entropy kernels' tolerances stand above
their tests. ``chip_smoke.py`` covers the main paths' full-size shapes.
"""

from __future__ import annotations

import pytest
import torch

from icikit_torch.ops import cuda_sort as cs

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _rand(n, dtype, gen):
    if dtype == torch.float32:
        return torch.randn(n, generator=gen, device="cuda")
    return torch.randint(-2**31, 2**31 - 1, (n,), generator=gen,
                         dtype=torch.int32, device="cuda")


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_net_and_cross_passes_match_plain_versions(dtype, gen):
    x = _rand(1 << 16, dtype, gen)
    for log2t in (9, 13, 14):
        rounds = cs._sort_rounds(log2t)
        assert torch.equal(cs.net_pass(x, 1 << log2t, rounds),
                           cs.net_pass_plain(x, 1 << log2t, rounds))
    for lo, hi in ((0, 2), (1, 2), (0, 0)):
        for merge_only in (False, True):
            assert torch.equal(
                cs.cross_pass(x, 1 << 16, 1 << 13, lo, hi, merge_only),
                cs.cross_pass_plain(x, 1 << 16, 1 << 13, lo, hi,
                                    merge_only))


def test_in_place_passes_and_launch_counts(gen):
    x = _rand(1 << 16, torch.int32, gen)
    want = cs.local_sort(x, plain=True)
    cs.reset_launches()
    got = cs.local_sort(x)
    plan = cs.sort_schedule(1 << 16)
    assert cs.LAUNCHES == {
        "net": sum(s[0] == "net" for s in plan),
        "cross": sum(s[0] == "cross" for s in plan)}
    assert torch.equal(got, want)
    assert torch.equal(got, torch.sort(x).values)


@pytest.mark.parametrize("dtype", [torch.uint32, torch.bfloat16])
def test_local_sort_through_the_bijection_and_widening(dtype, gen):
    x = _rand(50_000, torch.float32 if dtype == torch.bfloat16
              else torch.int32, gen)
    x = x.to(dtype) if dtype == torch.bfloat16 else x.view(dtype)
    got, want = cs.local_sort(x), cs.local_sort(x, plain=True)
    assert got.dtype == dtype
    if dtype == torch.uint32:
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    else:
        assert torch.equal(got.float(), want.float())


def test_merge_bitonic_rows(gen):
    a = torch.sort(_rand(1 << 15, torch.int32, gen).view(4, -1)).values
    b = torch.sort(_rand(1 << 15, torch.int32, gen).view(4, -1),
                   descending=True).values
    v = torch.cat([a, b], dim=1)
    assert torch.equal(cs.merge_bitonic(v), cs.merge_bitonic(v, plain=True))


def test_a_cuda_tensor_never_takes_the_plain_version(gen):
    x = _rand(1 << 13, torch.int32, gen)
    with pytest.raises(ValueError, match="outside the kernel"):
        cs.net_pass(x, 1 << 4, cs._sort_rounds(3))
    with pytest.raises(ValueError, match="int32/float32"):
        cs.net_pass(x.double(), 1 << 13, cs._sort_rounds(3))


# ------------------------------------------------- attention kernels
# Tolerances: float32 out and lse 1e-4 (the kernel sums in another
# order than the plain version); bf16 out 2e-2 and lse 1e-3 (both round
# P to bf16 before PV, but against different row maxima: the kernel's
# running max, the plain version's final one); cache columns bitwise.

from icikit_torch.ops import cuda_attention as ca  # noqa: E402
from icikit_torch.ops.rope import rope_sincos  # noqa: E402


def _randn(shape, dtype, gen):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


@pytest.fixture
def no_tf32(gen):
    """float32 products in full float32 for the plain versions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return gen


# The flash kernels' edges: lengths on and beside their tiles (64 or 128
# rows or keys a ring stage, 64 or 128 Q rows or keys a CTA), at every
# head dim built.
BWD_EDGE_SHAPES = [(s, d) for s in (65, 127, 129, 1000, 4097)
                   for d in (32, 64, 128, 256)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("s,d", [(64, 128), (200, 128), (512, 64),
                                 (200, 256)] + BWD_EDGE_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_matches_plain(dtype, tol, s, d, causal, no_tf32):
    gen = no_tf32
    q, k, v = (_randn((2, 3, s, d), dtype, gen) for _ in range(3))
    ca.reset_launches()
    out, lse = ca.flash_fwd(q, k, v, causal, d ** -0.5)
    assert ca.LAUNCHES["flash_fwd"] == 1
    want, want_lse = ca.flash_fwd_plain(q, k, v, causal, d ** -0.5)
    assert out.dtype == dtype and lse.dtype == torch.float32
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=0)
    torch.testing.assert_close(lse, want_lse,
                               atol=1e-4 if dtype == torch.float32
                               else 1e-3, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("cur", [0, 1, 37, 95])
@pytest.mark.parametrize("dh", [128, 256, 384])
def test_decode_step_matches_plain_and_writes_in_place(dtype, rope, cur, dh,
                                                       no_tf32):
    gen = no_tf32
    rows, total = 6, 96
    q, k, v = (_randn((rows, dh), dtype, gen) for _ in range(3))
    kc, vc = (_randn((rows, total, dh), dtype, gen) for _ in range(2))
    c, s = rope_sincos(torch.tensor([cur], device="cuda"), dh)
    cos2, sin2 = torch.cat([c, c], -1), torch.cat([s, s], -1)
    kc2, vc2 = kc.clone(), vc.clone()
    want = ca.decode_step_plain(q, k, v, kc2, vc2, cur, cos2, sin2,
                                scale=dh ** -0.5, rope=rope)
    ca.reset_launches()
    got = ca.decode_step(q, k, v, kc, vc, cur, cos2, sin2,
                         scale=dh ** -0.5, rope=rope)
    assert ca.LAUNCHES["decode_step"] == 1
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    assert torch.equal(kc, kc2) and torch.equal(vc, vc2)


def test_attention_cuda_calls_launch_or_raise(gen):
    """A CUDA tensor launches the kernel (the counter moves) or raises;
    it never takes the plain version."""
    q = _randn((1, 2, 64, 128), torch.bfloat16, gen)
    ca.reset_launches()
    ca.flash_fwd(q, q, q, True, 0.1)
    assert ca.LAUNCHES["flash_fwd"] == 1
    with pytest.raises(ValueError, match="head dim"):
        ca.flash_fwd(q[..., :48].contiguous(), q[..., :48].contiguous(),
                     q[..., :48].contiguous(), True, 0.1)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        h = q.half()
        ca.flash_fwd(h, h, h, True, 0.1)
    assert ca.LAUNCHES["flash_fwd"] == 1


# ------------------------------------------------- train-path kernels
# Tolerances: float32 out and lse 1e-4, gradients 1e-4 of their largest
# entry (sums in other orders; dq by atomics in a varying order); bf16
# out 2e-2, lse 1e-3 and gradients 2e-2 of their largest entry (P and
# dS rounded to bf16 by both, against lse values that differ in the last
# float32 bits). The cross-entropy head: lse and target logit 1e-4
# (float32) and 1e-3 (bf16, the same exact bf16 products summed in
# another order); dx and dw 1e-4 of their largest entry at float32 and
# 2e-2 at bf16, where the kernels round g to bf16 for the tensor cores
# and the plain version contracts it in float32.


def _grad_close(got, want, rel):
    for a, b in zip(got, want):
        scale = max(float(b.float().abs().max()), 1e-30)
        torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                   atol=rel * scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,d", [(64, 128), (200, 128), (512, 64),
                                 (256, 32), (200, 256)] + BWD_EDGE_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_shift_and_backward_match_plain(dtype, s, d, causal,
                                              no_tf32):
    gen = no_tf32
    q, k, v, do = (_randn((2, 3, s, d), dtype, gen) for _ in range(4))
    scale = d ** -0.5
    ca.reset_launches()
    out, lse = ca.flash_fwd(q, k, v, causal, scale, shift=16.0)
    want, want_lse = ca.flash_fwd_plain(q, k, v, causal, scale, shift=16.0)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=0)
    torch.testing.assert_close(lse, want_lse, rtol=0,
                               atol=1e-4 if dtype == torch.float32
                               else 1e-3)
    delta = (do.float() * out.float()).sum(-1) \
        - 0.1 * torch.randn(lse.shape, generator=gen, device="cuda")
    got = ca.flash_bwd(q, k, v, do, lse, delta, causal, scale)
    assert ca.LAUNCHES["flash_fwd"] == 1 and ca.LAUNCHES["flash_bwd"] == 1
    assert [g.dtype for g in got] == [dtype] * 3
    _grad_close(got, ca.flash_bwd_plain(q, k, v, do, lse, delta, causal,
                                        scale),
                1e-4 if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_shift_overflow_redoes_the_tile_online(dtype, no_tf32):
    gen = no_tf32
    q, k, v = (_randn((1, 4, 256, 64), dtype, gen) for _ in range(3))
    hot = (q.float() * 400.0).to(dtype)
    out, lse = ca.flash_fwd(hot, k, v, True, 0.125, shift=16.0)
    ref, ref_lse = ca.flash_fwd(hot, k, v, True, 0.125)
    assert bool(torch.isfinite(lse).all()) and bool(
        torch.isfinite(out.float()).all())
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=1e-5 if dtype == torch.float32
                               else 2e-2)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-6, atol=0)


# The overflow redo at the forward's tile edges: q x 400 only in the
# second warpgroup's 64 rows of each 128-row CTA (rows 64-127 and 192-255
# of s 256), and only in the ragged last Q tile of s 1000 (rows 960-999).
REDO_EDGES = [(256, ((64, 128), (192, 256))), (1000, ((960, 1000),))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("s,hot", REDO_EDGES)
def test_flash_shift_overflow_redo_at_the_tile_edges(dtype, d, s, hot,
                                                     no_tf32):
    """The CTA-wide redo catches hot rows wherever they lie in the tile:
    their rows carry the online pass's bits, and every row stays within
    the plain version's (which falls back row by row) tolerance; the hot
    rows' lse errors relative to their largest |lse|, as phase 10 of
    chip_smoke.py holds q x 400, the other rows' absolute."""
    gen = no_tf32
    q, k, v = (_randn((1, 4, s, d), dtype, gen) for _ in range(3))
    for a, b in hot:
        q[:, :, a:b] = (q[:, :, a:b].float() * 400.0).to(dtype)
    out, lse = ca.flash_fwd(q, k, v, True, 0.125, shift=16.0)
    ref, ref_lse = ca.flash_fwd(q, k, v, True, 0.125)
    want, want_lse = ca.flash_fwd_plain(q, k, v, True, 0.125, shift=16.0)
    assert bool(torch.isfinite(lse).all()) and bool(
        torch.isfinite(out.float()).all())
    rows = torch.cat([torch.arange(a, b) for a, b in hot]).cuda()
    assert torch.equal(out[:, :, rows], ref[:, :, rows])
    assert torch.equal(lse[:, :, rows], ref_lse[:, :, rows])
    f32 = dtype == torch.float32
    torch.testing.assert_close(out.float(), want.float(), rtol=0,
                               atol=1e-4 if f32 else 2e-2)
    tol = 1e-4 if f32 else 1e-3
    is_hot = torch.zeros(s, dtype=torch.bool, device=rows.device)
    is_hot[rows] = True
    torch.testing.assert_close(
        lse[:, :, is_hot], want_lse[:, :, is_hot], rtol=0,
        atol=tol * float(want_lse[:, :, is_hot].abs().max()))
    torch.testing.assert_close(lse[:, :, ~is_hot], want_lse[:, :, ~is_hot],
                               rtol=0, atol=tol)


def test_flash_attention_runs_the_tiny_head_dim(gen):
    """d_head 32 (the tiny preset) launches the kernels, forward and
    backward, and matches the dense oracle."""
    from icikit_torch.ops.attention import dense_attention
    from icikit_torch.ops.flash_attention import flash_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = (_randn((2, 96, 4, 32), torch.float32, gen)
               .requires_grad_(True) for _ in range(3))
    ca.reset_launches()
    out = flash_attention(q, k, v, causal=True, softmax_shift=16.0)
    out.sum().backward()
    assert ca.LAUNCHES["flash_fwd"] == 1 and ca.LAUNCHES["flash_bwd"] == 1
    grads = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    want = dense_attention(q, k, v, causal=True)
    want.sum().backward()
    torch.testing.assert_close(out, want, atol=1e-4, rtol=0)
    _grad_close(grads, [t.grad for t in (q, k, v)], 1e-4)


from icikit_torch.ops import cuda_xent as cx  # noqa: E402


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d,v", [(256, 128, 512), (300, 136, 1000)])
def test_xent_kernels_match_plain(dtype, t, d, v, no_tf32):
    gen = no_tf32
    x = _randn((t, d), dtype, gen)
    w = (torch.randn((v, d), generator=gen, device="cuda")
         * d ** -0.5).to(dtype)
    tg = torch.randint(0, v, (t,), generator=gen, device="cuda",
                       dtype=torch.int32)
    dn = torch.randn((t,), generator=gen, device="cuda")
    cx.reset_launches()
    lse, tgt, e, mrun = cx.xent_fwd(x, w, tg, save=True)
    chunk = cx.TILE[dtype]
    plse, ptgt, pe, pm = cx.xent_fwd_plain(x, w, tg, True, chunk)
    tol = 1e-4 if dtype == torch.float32 else 1e-3
    torch.testing.assert_close(lse, plse, atol=tol, rtol=0)
    torch.testing.assert_close(tgt, ptgt, atol=tol, rtol=0)
    assert e.dtype == dtype and mrun.shape == pm.shape
    dx = cx.xent_dx_saved(e, mrun, w, tg, lse, dn)
    dw = cx.xent_dw_saved(e, mrun, x, tg, lse, dn)
    assert cx.LAUNCHES == {"xent_fwd": 1, "xent_dx_saved": 1,
                           "xent_dw_saved": 1, "xent_dx": 0, "xent_dw": 0,
                           "xent_g": 0, "xent_g_saved": 0}
    _grad_close((dx, dw),
                (cx.xent_dx_saved_plain(pe, pm, w, tg, plse, dn, chunk),
                 cx.xent_dw_saved_plain(pe, pm, x, tg, plse, dn, chunk)),
                1e-4 if dtype == torch.float32 else 2e-2)
    again = cx.xent_fwd(x, w, tg, save=False)       # counters reset
    torch.testing.assert_close(again[0], lse, atol=0, rtol=0)


def test_train_step_launches_every_kernel(gen):
    """One tiny train step on the card: each layer launches flash_fwd
    and flash_bwd once, the head each xent kernel once; the loss agrees
    with the same step on the CPU (plain versions)."""
    from icikit_torch.models.transformer import (FusedAdam,
                                                 TransformerConfig,
                                                 init_params,
                                                 make_model_mesh,
                                                 make_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TransformerConfig(vocab=256, d_model=128, n_heads=4, d_head=32,
                            d_ff=256, n_layers=2, max_seq=64,
                            compute_dtype="float32",
                            remat_policy="except_attn")
    cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tok = torch.randint(0, 256, (2, 64), generator=torch.Generator()
                        .manual_seed(1), dtype=torch.int32)
    losses = {}
    for dev in ("cpu", "cuda"):
        params = {k: v.clone().to(dev) for k, v in cpu.items()}
        opt, step = make_train_step(make_model_mesh(device=dev), cfg,
                                    FusedAdam(1e-3))
        ca.reset_launches()
        cx.reset_launches()
        _, _, loss = step(params, opt.init(params), tok.to(dev),
                          tok.roll(1, 1).to(dev))
        losses[dev] = float(loss)
    assert ca.LAUNCHES == {"flash_fwd": 2, "flash_bwd": 2, "flash_bwd_dq": 0,
                           "flash_bwd_dkv": 0, "decode_step": 0,
                           "decode_step_q8": 0}
    assert cx.LAUNCHES == {"xent_fwd": 1, "xent_dx_saved": 1,
                           "xent_dw_saved": 1, "xent_dx": 0, "xent_dw": 0,
                           "xent_g": 0, "xent_g_saved": 0}
    assert abs(losses["cuda"] - losses["cpu"]) < 1e-4


# ------------------------------------------- the train step's other arms
# Tolerances: the two-pass backward as flash_bwd's (float32 1e-4 of the
# largest entry, bf16 2e-2); the recompute and g kernels: float32 1e-4 of
# the largest entry (the logits summed in another order), bf16 2e-2 (g
# rounded to bf16 by both, the bf16 dx/dw contracting it against the
# plain version's float32); the Adam kernel bit for bit (the same float32
# operations, each rounded once, in the same order).


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,d", [(64, 128), (200, 128), (512, 64),
                                 (256, 32), (200, 256)] + BWD_EDGE_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_two_pass_matches_plain(dtype, s, d, causal, no_tf32):
    gen = no_tf32
    q, k, v, do = (_randn((2, 3, s, d), dtype, gen) for _ in range(4))
    scale = d ** -0.5
    out, lse = ca.flash_fwd(q, k, v, causal, scale)
    delta = (do.float() * out.float()).sum(-1) \
        - 0.1 * torch.randn(lse.shape, generator=gen, device="cuda")
    ca.reset_launches()
    dq = ca.flash_bwd_dq(q, k, v, do, lse, delta, causal, scale)
    dk, dv = ca.flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
    assert ca.LAUNCHES["flash_bwd_dq"] == 1
    assert ca.LAUNCHES["flash_bwd_dkv"] == 1 and ca.LAUNCHES["flash_bwd"] == 0
    assert [g.dtype for g in (dq, dk, dv)] == [dtype] * 3
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    want = ca.flash_bwd_plain(q, k, v, do, lse, delta, causal, scale)
    _grad_close((dq, dk, dv), want, tol)
    # the plain versions chunk by chunk agree with the whole-matrix form
    # (in bf16 to the kernels' tolerance: cuBLAS sums the logits of other
    # shapes in other orders, and P is rounded to bf16 after that)
    _grad_close((ca.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal,
                                       scale, chunk=96),
                 *ca.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal,
                                         scale, chunk=96)), want, tol)
    # deterministic: a second run gives the same bits
    assert torch.equal(dq, ca.flash_bwd_dq(q, k, v, do, lse, delta, causal,
                                           scale))
    dk2, dv2 = ca.flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


def test_flash_attention_takes_the_two_pass_route_past_the_budget(
        gen, monkeypatch):
    from icikit_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = (_randn((1, 300, 2, 64), torch.float32, gen)
               .requires_grad_(True) for _ in range(3))
    grads = {}
    for budget in (fa._DQ_SCRATCH_BYTES_MAX, 0):
        monkeypatch.setattr(fa, "_DQ_SCRATCH_BYTES_MAX", budget)
        ca.reset_launches()
        fa.flash_attention(q, k, v, causal=True).sum().backward()
        grads[budget] = [t.grad.clone() for t in (q, k, v)]
        for t in (q, k, v):
            t.grad = None
        two = budget == 0
        assert ca.LAUNCHES["flash_bwd"] == int(not two)
        assert ca.LAUNCHES["flash_bwd_dq"] == ca.LAUNCHES[
            "flash_bwd_dkv"] == int(two)
    _grad_close(grads[0], grads[fa._DQ_SCRATCH_BYTES_MAX], 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d,v", [(256, 128, 512), (300, 136, 1000)])
def test_xent_recompute_and_g_kernels_match_plain(dtype, t, d, v, no_tf32):
    gen = no_tf32
    x = _randn((t, d), dtype, gen)
    w = (torch.randn((v, d), generator=gen, device="cuda")
         * d ** -0.5).to(dtype)
    tg = torch.randint(0, v, (t,), generator=gen, device="cuda",
                       dtype=torch.int32)
    dn = torch.randn((t,), generator=gen, device="cuda")
    lse, tgt, e, mrun = cx.xent_fwd(x, w, tg, save=True)
    chunk = cx.TILE[dtype]
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    cx.reset_launches()
    g = cx.xent_g(x, w, tg, lse, dn)
    gs = cx.xent_g_saved(e, mrun, tg, lse, dn)
    dx = cx.xent_dx(x, w, tg, lse, dn)
    dw = cx.xent_dw(x, w, tg, lse, dn)
    assert {k: cx.LAUNCHES[k] for k in ("xent_g", "xent_g_saved", "xent_dx",
                                        "xent_dw")} == dict.fromkeys(
        ("xent_g", "xent_g_saved", "xent_dx", "xent_dw"), 1)
    assert g.dtype == gs.dtype == dx.dtype == dw.dtype == dtype
    _grad_close((g, dx, dw), (cx.xent_g_plain(x, w, tg, lse, dn),
                              cx.xent_dx_plain(x, w, tg, lse, dn),
                              cx.xent_dw_plain(x, w, tg, lse, dn)), tol)
    _grad_close((gs,), (cx.xent_g_saved_plain(e, mrun, tg, lse, dn,
                                              chunk),), 1e-5)
    # the recomputed and the saved g are the same softmax
    _grad_close((gs,), (g,), tol)


from icikit_torch.ops import cuda_adam  # noqa: E402


@pytest.mark.parametrize("mom", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grad", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ok", [None, True, False])
def test_adam_kernel_matches_plain_bitwise(mom, grad, ok, gen):
    from icikit_torch.ops.adam import adam_scalars

    sc = adam_scalars(3e-3, torch.tensor(7, device="cuda"))
    flag = None if ok is None else torch.tensor(ok, device="cuda")
    for shape in ((1000,), (24, 128), (3, 5, 7)):
        p = torch.randn(shape, generator=gen, device="cuda")
        m = (0.1 * torch.randn(shape, generator=gen, device="cuda")).to(mom)
        v = (0.01 * torch.rand(shape, generator=gen, device="cuda")).to(mom)
        g = torch.randn(shape, generator=gen, device="cuda").to(grad)
        pk, mk, vk = p.clone(), m.clone(), v.clone()
        cuda_adam.reset_launches()
        cuda_adam.adam_leaf(pk, mk, vk, g, sc, 0.9, 0.999, 1e-8, flag)
        assert cuda_adam.LAUNCHES["adam"] == 1
        cuda_adam.adam_leaf_plain(p, m, v, g, sc, 0.9, 0.999, 1e-8, flag)
        assert torch.equal(pk, p) and torch.equal(mk, m) \
            and torch.equal(vk, v)
        if ok is False:
            assert cuda_adam.LAUNCHES["adam"] == 1


def _tree(sizes, grads, mom, gen, offset=0):
    """Leaves of ``sizes`` with gradients of ``grads`` in turn, as views
    ``offset`` elements into their buffers."""
    out = []
    for i, n in enumerate(sizes):
        def mk(dtype, scale, n=n):
            t = scale * torch.randn(n + offset, generator=gen, device="cuda")
            return (t.abs() if scale == 0.01 else t).to(dtype)[offset:]
        out.append((mk(torch.float32, 1.0), mk(mom, 0.1), mk(mom, 0.01),
                    mk(grads[i % len(grads)], 1.0)))
    return [list(t) for t in zip(*out)]


@pytest.mark.parametrize("mom", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ok", [None, True, False])
def test_adam_tree_matches_plain_bitwise(mom, ok, gen):
    """One launch over a tree of mixed gradient dtypes, sizes 1, 7, 1000
    and 2^20 + 3 (one element, a scalar tail, several chunks), beside
    leaves that are views 4 bytes and 2 elements into their buffers (a
    scalar head), equals the plain version bit for bit."""
    from icikit_torch.ops.adam import adam_scalars

    sc = adam_scalars(3e-3, torch.tensor(7, device="cuda"))
    flag = None if ok is None else torch.tensor(ok, device="cuda")
    grads = (torch.bfloat16, torch.float32, torch.float16)
    leaves = [a + b + c for a, b, c in zip(
        _tree((1, 7, 1000, (1 << 20) + 3), grads, mom, gen),
        _tree((5000,), grads, mom, gen, offset=1),
        _tree((4099,), (torch.float16,), mom, gen, offset=2))]
    ref = [[t.clone() for t in ts] for ts in leaves[:3]]
    cuda_adam.reset_launches()
    cuda_adam.adam_tree(*leaves, sc, 0.9, 0.999, 1e-8, flag)
    assert cuda_adam.LAUNCHES["adam"] == 1
    cuda_adam.adam_tree_plain(*ref, leaves[3], sc, 0.9, 0.999, 1e-8, flag)
    for got, want in zip(leaves[:3], ref):
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("mom", [torch.float32, torch.bfloat16])
def test_adam_tree_of_100_leaves_takes_three_launches(mom, gen):
    """A tree past one table (48 leaves) takes one launch a table, and
    equals the plain version bit for bit."""
    from icikit_torch.ops.adam import adam_scalars

    sc = adam_scalars(1e-3, torch.tensor(2, device="cuda"))
    sizes = [int(n) for n in torch.randint(1, 9000, (100,), generator=gen,
                                           device="cuda").tolist()]
    leaves = _tree(sizes, (torch.float32, torch.bfloat16, torch.float16),
                   mom, gen)
    ref = [[t.clone() for t in ts] for ts in leaves[:3]]
    cuda_adam.reset_launches()
    cuda_adam.adam_tree(*leaves, sc, 0.9, 0.999, 1e-8)
    assert cuda_adam.LAUNCHES["adam"] == 3
    cuda_adam.adam_tree_plain(*ref, leaves[3], sc, 0.9, 0.999, 1e-8)
    for got, want in zip(leaves[:3], ref):
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("arm", ["recompute", "matmul-saved",
                                 "matmul-recompute", "adam-kernel"])
def test_train_step_arms_launch_their_kernels(arm, gen):
    """One tiny train step on the card in each arm launches that arm's
    kernels once a step (the Adam kernel once, over the whole tree) and
    agrees with the same step on the CPU."""
    from icikit_torch.models.transformer import (FusedAdam,
                                                 TransformerConfig,
                                                 init_params,
                                                 make_model_mesh,
                                                 make_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    head = dict(xent_save_exp=arm != "recompute" and arm != "matmul-recompute",
                xent_fused_bwd=not arm.startswith("matmul"))
    cfg = TransformerConfig(vocab=256, d_model=128, n_heads=4, d_head=32,
                            d_ff=256, n_layers=2, max_seq=64,
                            compute_dtype="float32",
                            remat_policy="except_attn", **head)
    cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tok = torch.randint(0, 256, (2, 64), generator=torch.Generator()
                        .manual_seed(1), dtype=torch.int32)
    losses = {}
    for dev in ("cpu", "cuda"):
        params = {k: x.clone().to(dev) for k, x in cpu.items()}
        opt, step = make_train_step(
            make_model_mesh(device=dev), cfg,
            FusedAdam(1e-3, use_pallas=arm == "adam-kernel"))
        st = opt.init(params)
        step(params, st, tok.to(dev), tok.roll(1, 1).to(dev))
        cx.reset_launches()
        cuda_adam.reset_launches()
        _, _, loss = step(params, st, tok.to(dev), tok.roll(1, 1).to(dev))
        losses[dev] = float(loss)
    want = {"recompute": {"xent_fwd": 1, "xent_dx": 1, "xent_dw": 1},
            "matmul-saved": {"xent_fwd": 1, "xent_g_saved": 1},
            "matmul-recompute": {"xent_fwd": 1, "xent_g": 1},
            "adam-kernel": {"xent_fwd": 1, "xent_dx_saved": 1,
                            "xent_dw_saved": 1}}[arm]
    assert {k: n for k, n in cx.LAUNCHES.items() if n} == want
    assert cuda_adam.LAUNCHES["adam"] == (1 if arm == "adam-kernel" else 0)
    assert abs(losses["cuda"] - losses["cpu"]) < 1e-4


# ------------------------------------------------- int8 decode kernels
# Tolerances: quant_matvec 1e-4 of the largest |reference| entry for bf16
# x (exact products, float32 sums on the tensor cores in another order)
# and 1e-5 for float32 x (FMA sums in another order); decode_step_q8 out
# 1e-5 absolute (float32 sums in another order, the same scale folding)
# and the int8 cache columns bit for bit.

from icikit_torch.ops import cuda_quant as cq  # noqa: E402

QMV_TOL = {torch.bfloat16: 1e-4, torch.float32: 1e-5}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows", [1, 8, 16, 17, 300])
@pytest.mark.parametrize("n,k", [(256, 128), (3072, 1024), (1024, 4096)])
def test_quant_matvec_matches_plain(dtype, rows, n, k, no_tf32):
    gen = no_tf32
    x = _randn((rows, k), dtype, gen)
    w8 = torch.randint(-127, 128, (n, k), generator=gen, device="cuda",
                       dtype=torch.int8)
    sc = torch.rand((n,), generator=gen, device="cuda") / 127
    cq.reset_launches()
    got = cq.quant_matvec(x, w8, sc)
    assert cq.LAUNCHES["quant_matvec"] == 1 and got.dtype == torch.float32
    want = cq.quant_matvec_plain(x, w8, sc)
    torch.testing.assert_close(got, want, rtol=0, atol=QMV_TOL[dtype]
                               * float(want.abs().max()))


def test_quant_matvec_gate_and_qmm_routes(gen):
    """Off the gate a CUDA call raises (and ``qmm(impl="pallas")`` with
    it); ``"auto"`` launches the kernel where the gate accepts and takes
    the plain form where it does not; ``"xla"`` never launches."""
    from icikit_torch.ops.quant import qmm, quant_matvec

    x = _randn((4, 8, 256), torch.bfloat16, gen)
    w8 = torch.randint(-127, 128, (384, 256), generator=gen, device="cuda",
                       dtype=torch.int8)
    sc = torch.rand((384,), generator=gen, device="cuda")
    with pytest.raises(ValueError, match="unsupported"):
        quant_matvec(x[0, :, :200].contiguous(), w8[:, :200].contiguous(),
                     sc)
    with pytest.raises(ValueError, match="unsupported"):
        qmm(x[..., :200], w8[:, :200], sc, impl="pallas")
    cq.reset_launches()
    a = qmm(x, w8, sc, impl="auto")
    assert cq.LAUNCHES["quant_matvec"] == 1 and a.shape == (4, 8, 384)
    b = qmm(x, w8, sc, impl="xla")
    qmm(x[..., :200], w8[:, :200], sc, impl="auto")
    assert cq.LAUNCHES["quant_matvec"] == 1
    torch.testing.assert_close(a, b, rtol=0,
                               atol=1e-4 * float(b.abs().max()))


@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [128, 256, 384])
@pytest.mark.parametrize("cur", [0, 1, 37, 95])
def test_decode_step_q8_matches_plain_and_writes_in_place(qdtype, dh, cur,
                                                          no_tf32):
    from icikit_torch.ops.quant import dequantize_last, quantize_last

    gen = no_tf32
    rows, total = 6, 96
    q = _randn((rows, dh), qdtype, gen)
    kq, ks = quantize_last(_randn((rows, dh), torch.float32, gen))
    vq, vs = quantize_last(_randn((rows, dh), torch.float32, gen))
    kc, kcs = quantize_last(_randn((rows, total, dh), torch.float32, gen))
    vc, vcs = quantize_last(_randn((rows, total, dh), torch.float32, gen))
    kcs[:, cur], vcs[:, cur] = ks, vs
    kc2, vc2 = kc.clone(), vc.clone()
    args = (kq, vq, dequantize_last(kq, ks), dequantize_last(vq, vs))
    want = ca.decode_step_q8_plain(q, *args, kc2, vc2, kcs, vcs, cur,
                                   scale=dh ** -0.5)
    ca.reset_launches()
    got = ca.decode_step_q8(q, *args, kc, vc, kcs, vcs, cur,
                            scale=dh ** -0.5)
    assert ca.LAUNCHES["decode_step_q8"] == 1 and got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert torch.equal(kc, kc2) and torch.equal(vc, vc2)


@pytest.mark.parametrize("pos_encoding", ["learned", "rope"])
def test_int8_generate_launches_b14_and_b15(pos_encoding, gen):
    """The int8 fused generate of tiny128 on the card launches the int8
    matvec for every projection and the unembedding and the int8 step
    once a layer a step, and at float32 gives the plain arms' tokens."""
    import dataclasses

    from icikit_torch.bench.train import PRESETS
    from icikit_torch.models.transformer import (TransformerConfig,
                                                 greedy_generate,
                                                 init_params,
                                                 make_model_mesh)

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TransformerConfig(**PRESETS["tiny128"], compute_dtype="float32",
                            pos_encoding=pos_encoding, decode_quant="int8",
                            decode_step="fused", quant_matvec="auto")
    params = init_params(cfg, gen, "cuda")
    prompt = torch.randint(0, cfg.vocab, (2, 8), generator=gen,
                           device="cuda", dtype=torch.int32)
    mesh = make_model_mesh(device="cuda")
    ca.reset_launches()
    cq.reset_launches()
    got = greedy_generate(params, prompt, mesh, cfg, 10)
    L = cfg.n_layers
    assert ca.LAUNCHES["decode_step_q8"] == L * 9
    assert ca.LAUNCHES["decode_step"] == 0
    assert cq.LAUNCHES["quant_matvec"] == 10 * (4 * L + 1)
    want = greedy_generate(params, prompt, mesh, dataclasses.replace(
        cfg, decode_step="unfused", quant_matvec="xla",
        attention_impl="dense"), 10)
    assert torch.equal(got, want)


def test_flash_attention_routes_unbuilt_head_dims_to_dense(gen):
    """A CUDA call at a head dim the kernels are not built for (96)
    takes the dense oracle, decided before any launch; d 256 launches."""
    from icikit_torch.ops.attention import dense_attention
    from icikit_torch.ops.flash_attention import flash_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    for d, launches in ((96, 0), (256, 1)):
        q, k, v = (_randn((1, 80, 2, d), torch.float32, gen)
                   for _ in range(3))
        ca.reset_launches()
        out = flash_attention(q, k, v, causal=True)
        assert ca.LAUNCHES["flash_fwd"] == launches
        torch.testing.assert_close(out, dense_attention(q, k, v, causal=True),
                                   atol=1e-4, rtol=0)


def test_d_head_256_generate_and_train_step(gen):
    """A d_head-256 MHA config on the card: greedy_generate launches the
    prefill's flash_fwd and the fused step at float32 and gives the
    plain arms' tokens; a train step launches flash_fwd and flash_bwd and
    its loss equals the plain arms'."""
    import dataclasses

    from icikit_torch.models.transformer import (TransformerConfig,
                                                 greedy_generate,
                                                 init_params,
                                                 loss_and_metrics,
                                                 make_model_mesh)

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TransformerConfig(vocab=256, d_model=256, n_heads=2, d_head=256,
                            d_ff=512, n_layers=2, max_seq=64,
                            compute_dtype="float32", decode_step="fused",
                            pos_encoding="rope", remat=False)
    params = init_params(cfg, gen, "cuda")
    mesh = make_model_mesh(device="cuda")
    prompt = torch.randint(0, 256, (2, 16), generator=gen, device="cuda",
                           dtype=torch.int32)
    ca.reset_launches()
    got = greedy_generate(params, prompt, mesh, cfg, 6)
    assert ca.LAUNCHES["flash_fwd"] == 2 and ca.LAUNCHES["decode_step"] == 10
    plain = dataclasses.replace(cfg, decode_step="unfused",
                                attention_impl="dense")
    assert torch.equal(got, greedy_generate(params, prompt, mesh, plain, 6))
    tok = torch.randint(0, 256, (2, 64), generator=gen, device="cuda",
                        dtype=torch.int32)
    ca.reset_launches()
    loss, _, _ = loss_and_metrics(params, tok, tok.roll(1, 1), mesh, cfg)
    assert ca.LAUNCHES["flash_fwd"] == 2 and ca.LAUNCHES["flash_bwd"] == 2
    loss_p, _, _ = loss_and_metrics(params, tok, tok.roll(1, 1), mesh,
                                    dataclasses.replace(
                                        plain, fused_head=False))
    assert abs(float(loss) - float(loss_p)) < 1e-4


# ------------------------------------------- the save stack and B17
# Tolerances: the stack kernels bit for bit (a copy); the tile-floor
# kernels 2e-2 of the largest |plain| entry in bf16 (both round w to bf16
# before the value product, at scores whose float32 sums differ in order).


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("slice_shape", [(16, 128), (2, 8, 128), (1024,),
                                         (3072, 1024)])
def test_stack_kernels_match_plain_bitwise(dtype, slice_shape, gen):
    from icikit_torch.ops import cuda_stack as cst
    from icikit_torch.ops import stack_write as sw

    stack = _randn((5,) + slice_shape, dtype, gen)
    want = stack.clone()
    n = int(sw.stack_supported(slice_shape, dtype))   # (1024,) bf16: off
    for i in (0, 2, 4):
        x = _randn(slice_shape, torch.float32, gen)
        cst.reset_launches()
        sw.stack_write(stack, x, i)
        cst.stack_write_plain(want, x.to(dtype), i)
        got = sw.stack_read(stack, i)
        assert cst.LAUNCHES == {"stack_write": n, "stack_read": n}
        assert torch.equal(stack.view(torch.uint8), want.view(torch.uint8))
        assert torch.equal(got, cst.stack_read_plain(want, i))


@pytest.mark.parametrize("nbytes", [256, 48 * 1024 + 256, 32 * 1024 - 256,
                                    32 * 1024 + 256, 16 * 2 ** 20],
                         ids=str)
def test_stack_kernels_bitwise_at_the_copy_edges(nbytes, gen):
    """Slices of 256 B, 48 KiB + 256 B, a 32 KiB stage +- 256 B and
    16 MiB, bf16, through the raw wrappers and the layer loop's
    checked-once copier: bit for bit, one launch a call."""
    from icikit_torch.ops import cuda_stack as cst

    n = nbytes // 2
    stack = _randn((3, n), torch.bfloat16, gen)
    want = stack.clone()
    cp = cst.SliceCopier(stack)
    for i, write in ((0, lambda x, i: cst.stack_write(stack, x, i)),
                     (2, cp.write)):
        x = _randn((n,), torch.bfloat16, gen)
        cst.reset_launches()
        write(x, i)
        want[i] = x
        assert cst.LAUNCHES == {"stack_write": 1, "stack_read": 0}
        assert torch.equal(stack.view(torch.int16), want.view(torch.int16))
        for got in (cst.stack_read(stack, i), cp.read(i)):
            assert torch.equal(got.view(torch.int16),
                               want[i].view(torch.int16))
        assert cst.LAUNCHES["stack_read"] == 2
    with pytest.raises(ValueError, match="stack index"):
        cp.write(x, 3)
    with pytest.raises(ValueError, match="16-byte aligned"):
        cp.write(_randn((n + 1,), torch.bfloat16, gen)[1:], 0)


def test_stack_off_the_gate_takes_the_plain_copy_and_raw_calls_check(gen):
    from icikit_torch.ops import cuda_stack as cst
    from icikit_torch.ops import stack_write as sw

    stack = _randn((3, 9, 128), torch.bfloat16, gen)   # 9 % 16 rows
    x = _randn((9, 128), torch.bfloat16, gen)
    cst.reset_launches()
    sw.stack_write(stack, x, 1)
    assert torch.equal(sw.stack_read(stack, 1), x)
    assert cst.LAUNCHES == {"stack_write": 0, "stack_read": 0}
    # a direct kernel call on a CUDA tensor launches or raises
    cst.stack_write(stack, x, 2)
    assert cst.LAUNCHES["stack_write"] == 1 and torch.equal(stack[2], x)
    with pytest.raises(ValueError, match="dtype"):
        cst.stack_write(stack, x.float(), 0)
    with pytest.raises(ValueError, match="multiple of 16"):
        cst.stack_write(_randn((2, 5), torch.float32, gen),
                        _randn((5,), torch.float32, gen), 0)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("variant", ["mxu", "softmax_ks1", "no_exp2",
                                     "no_max", "no_exp2_no_max"])
def test_tile_floor_kernels_match_plain(variant, d, no_tf32):
    from icikit_torch.bench.tile_floor import ABLATIONS
    from icikit_torch.ops import cuda_tile_floor as ctf

    gen = no_tf32
    q, k, v = (_randn((1, 2, 256, d), torch.bfloat16, gen)
               for _ in range(3))
    s = d ** -0.5 * 1.442695
    ctf.reset_launches()
    if variant == "mxu":
        got, want = ctf.tile_mxu(q, k, v, s), ctf.mxu_plain(q, k, v, s)
        assert ctf.LAUNCHES == {"tile_mxu": 1, "tile_ablate": 0}
    else:
        flags = {n: (e, m) for n, e, m in ABLATIONS}[variant]
        got = ctf.tile_ablate(q, k, v, s, *flags)
        want = ctf.ablate_plain(q, k, v, s, *flags)
        assert ctf.LAUNCHES == {"tile_mxu": 0, "tile_ablate": 1}
    err = float((got.float() - want.float()).abs().max())
    assert err <= 2e-2 * float(want.float().abs().max())
    with pytest.raises(ValueError, match="head dims"):
        ctf.tile_mxu(*(t[..., :32].contiguous() for t in (q, k, v)), s)


def test_save_stack_step_launches_the_stack_kernels(gen):
    """One small save-stack step on the card: each layer writes its input
    and its four gated gradient slices (the norms' 128-element float32
    slices take the plain copy), reads its input back and runs the flash
    forward twice (the backward rebuilds the layer); the loss agrees with
    the default arm's."""
    from icikit_torch.models.transformer import (FusedAdam,
                                                 TransformerConfig,
                                                 init_params,
                                                 make_model_mesh,
                                                 make_train_step)
    from icikit_torch.ops import cuda_stack as cst

    torch.backends.cuda.matmul.allow_tf32 = False
    base = dict(vocab=256, d_model=128, n_heads=4, d_head=32, d_ff=256,
                n_layers=2, max_seq=64, compute_dtype="float32",
                remat_policy="except_attn")
    params = init_params(TransformerConfig(**base), gen, "cuda")
    tok = torch.randint(0, 256, (2, 64), generator=gen, device="cuda",
                        dtype=torch.int32)
    losses = {}
    for stack in ("xla", "pallas"):
        p = {k: v.clone() for k, v in params.items()}
        opt, step = make_train_step(
            make_model_mesh(device="cuda"),
            TransformerConfig(**base, save_stack=stack), FusedAdam(1e-3))
        ca.reset_launches()
        cst.reset_launches()
        _, _, loss = step(p, opt.init(p), tok, tok.roll(1, 1))
        torch.cuda.synchronize()
        losses[stack] = float(loss)
        if stack == "pallas":
            assert cst.LAUNCHES == {"stack_write": 2 * 5, "stack_read": 2}
            assert ca.LAUNCHES["flash_fwd"] == 4
            assert ca.LAUNCHES["flash_bwd"] == 2
    assert abs(losses["pallas"] - losses["xla"]) < 1e-5
