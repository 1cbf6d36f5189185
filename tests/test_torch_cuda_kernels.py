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

from icikit_torch.ops import _build
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
    for log2t in (10, 13, 15):
        rounds = cs._sort_rounds(log2t)
        assert torch.equal(cs.net_pass(x, 1 << log2t, rounds),
                           cs.net_pass_plain(x, 1 << log2t, rounds))
    for lo, hi in ((0, 2), (1, 2), (0, 0)):
        for merge_only in (False, True):
            assert torch.equal(
                cs.cross_pass(x, 1 << 16, 1 << 13, lo, hi, merge_only),
                cs.cross_pass_plain(x, 1 << 16, 1 << 13, lo, hi,
                                    merge_only))


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_passes_at_the_main_geometry_match_plain_versions(dtype, gen):
    """K1 at T_GRID (the in-tile sort, and a round pass whose direction
    bit lies above the tile, in place) and K2 at the main path's tile:
    G_MAX bits, a 1-bit pass, a middle range, merge_only, in place."""
    t, span = cs.T_GRID, 1 << 26
    x = _rand(span, dtype, gen)
    for rounds in (cs._sort_rounds(cs.ilog2(t)),
                   [(20, tuple(t >> i for i in range(1, cs.ilog2(t) + 1)))]):
        want = cs.net_pass_plain(x, t, rounds)
        assert torch.equal(cs.net_pass(x, t, rounds), want)
        y = x.clone()
        assert cs.net_pass(y, t, rounds, out=y) is y
        assert torch.equal(y, want)
    top = cs.ilog2(span // t) - 1
    for lo, hi in ((top - cs.G_MAX + 1, top), (0, 0), (2, 6)):
        for merge_only in (False, True):
            want = cs.cross_pass_plain(x, span, t, lo, hi, merge_only)
            assert torch.equal(cs.cross_pass(x, span, t, lo, hi, merge_only),
                               want)
            y = x.clone()
            assert cs.cross_pass(y, span, t, lo, hi, merge_only, out=y) is y
            assert torch.equal(y, want)


def test_local_sort_at_a_length_not_a_power_of_two(gen):
    for dtype in (torch.int32, torch.float32):
        x = _rand(1_000_003, dtype, gen)
        got = cs.local_sort(x)
        assert torch.equal(got, cs.local_sort(x, plain=True))
        assert torch.equal(got, torch.sort(x).values)


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


@pytest.mark.parametrize("rows,n", [(8, 1 << 13), (8, 1 << 17),
                                    (3, 100003), (2, 1 << 20)])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32, torch.uint32,
                                   torch.bfloat16])
def test_rows_local_sort_equals_the_per_row_loop(rows, n, dtype, gen):
    """``local_sort`` of (rows, n) sorts every row in the same launches,
    the top round ascending in each: bit for bit the loop over its
    rows, and torch.sort's values."""
    x = _rand(rows * n, torch.float32 if dtype == torch.bfloat16
              else torch.int32 if dtype == torch.uint32 else dtype, gen)
    x = (x.to(dtype) if dtype == torch.bfloat16
         else x.view(dtype)).view(rows, n)
    cs.reset_launches()
    got = cs.local_sort(x)
    torch.cuda.synchronize()
    launches = dict(cs.LAUNCHES)
    want = torch.stack([cs.local_sort(r) for r in x])
    if dtype == torch.uint32:   # torch.sort takes no uint32 on the card
        got, want, x = (cs._u32_as_i32(t) for t in (got, want, x))
    if dtype == torch.bfloat16:
        got, want, x = got.float(), want.float(), x.float()
    assert torch.equal(got, want)
    assert torch.equal(got, torch.sort(x, dim=1).values)
    np2 = n if n & (n - 1) == 0 else 1 << n.bit_length()
    assert launches["net"] + launches["cross"] == cs.sort_passes(np2)


@pytest.mark.parametrize("algorithm", ["sample", "sample_bitonic",
                                       "quicksort", "bitonic"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_distributed_sorts_on_the_card_equal_the_cpu_mesh(algorithm, dtype,
                                                           gen):
    """Each sort at 2^20 keys and p = 8 on the card launches both
    kernels and equals the same call on a CPU mesh (the plain versions),
    integers bit for bit and floats by value."""
    from icikit_torch.models.sort import sort
    from icikit_torch.utils.mesh import make_mesh
    x = _rand(1 << 20, dtype, gen)
    cs.reset_launches()
    got = sort(x, make_mesh(8), algorithm=algorithm)
    torch.cuda.synchronize()
    launches = dict(cs.LAUNCHES)
    want = sort(x.cpu(), make_mesh(8, device="cpu"), algorithm=algorithm)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, torch.sort(x).values)
    assert launches["net"] > 0 and launches["cross"] > 0, launches


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_sort_kv_on_the_card_equals_the_cpu_mesh(dtype, gen):
    """``sort_kv`` and ``argsort_dist`` at 2^20 keys, p = 8: the values
    follow the keys, as on a CPU mesh and as torch's stable argsort."""
    from icikit_torch.models.sort import argsort_dist, sort_kv
    from icikit_torch.utils.mesh import make_mesh
    x = _rand(1 << 20, dtype, gen)
    if dtype == torch.int32:
        x = x % 1000                      # duplicates: stability decides
    v = torch.arange(x.numel(), dtype=torch.int32, device="cuda")
    k, vals = sort_kv(x, v, make_mesh(8))
    ck, cv = sort_kv(x.cpu(), v.cpu(), make_mesh(8, device="cpu"))
    assert torch.equal(k.cpu(), ck) and torch.equal(vals.cpu(), cv)
    order = torch.argsort(x, stable=True)
    assert torch.equal(vals.long(), order)
    assert torch.equal(argsort_dist(x, make_mesh(8)).long(), order)


def test_uniform_block_on_the_card_equals_the_cpu():
    """The counter-hash draws are integer arithmetic: bit for bit on
    both devices; the odd_dist warp follows each device's float32 pow,
    within 4 ulp."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from icikit_torch.utils.prandom import uniform_block, uniform_global
    n = 1 << 20
    for start, block in ((0, n), (12345, 4096)):
        a = uniform_block(3, n, start, block, device="cuda").cpu()
        b = uniform_block(3, n, start, block, device="cpu")
        assert torch.equal(a, b)
        a = uniform_block(3, n, start, block, odd_dist=True,
                          device="cuda").cpu()
        b = uniform_block(3, n, start, block, odd_dist=True, device="cpu")
        ulps = (a.view(torch.int32).long() - b.view(torch.int32).long())
        assert int(ulps.abs().max()) <= 4
    assert torch.equal(uniform_global(3, n, odd_dist=True,
                                      device="cuda").cpu(),
                       uniform_global(3, n, odd_dist=True, device="cpu"))


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [128, 256, 384])
@pytest.mark.parametrize("cur", [0, 15, 16, 79, 80, 109, 543, 575])
@pytest.mark.parametrize("ctas_per_sm", [None, 64])
def test_decode_step_splits_match_plain(dtype, dh, cur, ctas_per_sm,
                                        no_tf32, monkeypatch):
    """The bf16 step (B13) split across CTAs at the bf16 path's 64 rows
    and 576 columns, over decode_splits' range: one split below 16
    columns (cur 0, 15), one at 16, 4 and then 5 splits on either side
    of cur 80 (where the picker's count changes), a split about 109
    columns wide, the path's cur 543 and the last column; with the
    picker's splits and with its splits for 64 CTAs an SM (33 splits of
    17 columns at cur 543, the last one empty). The output within the
    dtype's tolerance of the plain version (bf16: each split rounds its
    weights against its own max), the fresh columns written once, bit
    for bit, the rest of the caches untouched, the row counters left at
    zero, and a second call on the same workspace the same bits."""
    if ctas_per_sm:
        monkeypatch.setattr(ca, "DECODE_CTAS_PER_SM", ctas_per_sm)
    gen = no_tf32
    rows, total = 64, 576
    q, k, v = (_randn((rows, dh), dtype, gen) for _ in range(3))
    kc, vc = (_randn((rows, total, dh), dtype, gen) for _ in range(2))
    c, s = rope_sincos(torch.tensor([cur], device="cuda"), dh)
    cos2, sin2 = torch.cat([c, c], -1), torch.cat([s, s], -1)
    kc0, vc0 = kc.clone(), vc.clone()
    kc2, vc2 = kc.clone(), vc.clone()
    want = ca.decode_step_plain(q, k, v, kc2, vc2, cur, cos2, sin2,
                                scale=dh ** -0.5, rope=True)
    ca.reset_launches()
    got = ca.decode_step(q, k, v, kc, vc, cur, cos2, sin2,
                         scale=dh ** -0.5, rope=True)
    assert ca.LAUNCHES["decode_step"] == 1
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    assert torch.equal(kc, kc2) and torch.equal(vc, vc2)
    keep = torch.arange(total, device="cuda") != cur
    assert torch.equal(kc[:, keep], kc0[:, keep])
    assert torch.equal(vc[:, keep], vc0[:, keep])
    _, counter = _build.split_scratch(q, "decode", 0, 0)
    assert int(counter.abs().sum()) == 0
    again = ca.decode_step(q, k, v, kc, vc, cur, cos2, sin2,
                           scale=dh ** -0.5, rope=True)
    assert torch.equal(got, again)


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


def test_bf16_head_at_a_ragged_vocab_takes_the_stated_route(gen):
    """bf16 at V = 61, d = 128: the gate sends the head to the unfused
    path before any launch (the bf16 kernels read 16-byte rows of V), so
    a train step runs on the card with no xent launch and agrees with the
    same step on the CPU (bf16: 2e-2)."""
    from icikit_torch.models.transformer import (FusedAdam,
                                                 TransformerConfig,
                                                 init_params,
                                                 make_model_mesh,
                                                 make_train_step)

    cfg = TransformerConfig(vocab=61, d_model=128, n_heads=4, d_head=32,
                            d_ff=256, n_layers=2, max_seq=64,
                            compute_dtype="bfloat16")
    cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tok = torch.randint(0, 61, (2, 64), generator=torch.Generator()
                        .manual_seed(1), dtype=torch.int32)
    losses = {}
    for dev in ("cpu", "cuda"):
        params = {k: t.clone().to(dev) for k, t in cpu.items()}
        opt, step = make_train_step(make_model_mesh(device=dev), cfg,
                                    FusedAdam(1e-3))
        cx.reset_launches()
        _, _, loss = step(params, opt.init(params), tok.to(dev),
                          tok.roll(1, 1).to(dev))
        losses[dev] = float(loss)
    assert set(cx.LAUNCHES.values()) == {0}
    assert abs(losses["cuda"] - losses["cpu"]) < 2e-2 * abs(losses["cpu"])


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


# The bf16 recompute kernels (B10 recompute, one thread-block cluster
# along D) at shapes off every tile of theirs: T and V off the 128-row
# tile and the 64-wide step, D off the 256-column slices, at cluster sizes
# 1, 4 and 8 (with whole slices past D), and the base step's head; the
# tolerance as the recompute kernels' above (bf16 2e-2 of the largest
# entry).
@pytest.mark.parametrize("t,d,v", [(300, 136, 1000), (200, 520, 264),
                                   (130, 1544, 200), (64, 2048, 128),
                                   (1000, 1032, 4104), (8192, 1024, 32768)])
def test_xent_recompute_bf16_cluster_matches_plain(t, d, v, no_tf32):
    gen = no_tf32
    x = _randn((t, d), torch.bfloat16, gen)
    w = (torch.randn((v, d), generator=gen, device="cuda")
         * d ** -0.5).to(torch.bfloat16)
    tg = torch.randint(0, v, (t,), generator=gen, device="cuda",
                       dtype=torch.int32)
    dn = torch.randn((t,), generator=gen, device="cuda") / t
    lse, _ = cx.xent_fwd(x, w, tg, save=False)
    cx.reset_launches()
    got = (cx.xent_dx(x, w, tg, lse, dn), cx.xent_dw(x, w, tg, lse, dn))
    assert cx.LAUNCHES["xent_dx"] == cx.LAUNCHES["xent_dw"] == 1
    assert [g.shape for g in got] == [(t, d), (v, d)]
    _grad_close(got, (cx.xent_dx_plain(x, w, tg, lse, dn),
                      cx.xent_dw_plain(x, w, tg, lse, dn)), 2e-2)


# The saved flavour's bf16 kernels (B10 saved: a 128 x 256 tile a CTA on
# wgmma, g rebuilt in registers from e, 64-wide steps of the contraction)
# at shapes off every tile of theirs: T and V off the 128-row tile and the
# 64-wide step (an odd step count included), D off the 256-column slices
# (136, 520, 1032), D 2176 and 4096, and the base step's head; bf16 2e-2
# of the largest entry (g is rounded to bf16 for the tensor cores, the
# plain versions contract it in float32); the same bits from call to call.
@pytest.mark.parametrize("t,d,v", [(300, 136, 1000), (200, 520, 264),
                                   (1000, 1032, 4104), (130, 2176, 200),
                                   (256, 4096, 520), (8192, 1024, 32768)])
def test_xent_saved_bf16_matches_plain(t, d, v, no_tf32):
    gen = no_tf32
    x = _randn((t, d), torch.bfloat16, gen)
    w = (torch.randn((v, d), generator=gen, device="cuda")
         * d ** -0.5).to(torch.bfloat16)
    tg = torch.randint(0, v, (t,), generator=gen, device="cuda",
                       dtype=torch.int32)
    dn = torch.randn((t,), generator=gen, device="cuda") / t
    lse, _, e, mrun = cx.xent_fwd(x, w, tg, save=True)
    chunk = cx.TILE[torch.bfloat16]
    cx.reset_launches()
    got = (cx.xent_dx_saved(e, mrun, w, tg, lse, dn),
           cx.xent_dw_saved(e, mrun, x, tg, lse, dn))
    assert cx.LAUNCHES["xent_dx_saved"] == cx.LAUNCHES["xent_dw_saved"] == 1
    assert [g.shape for g in got] == [(t, d), (v, d)]
    _grad_close(got, (cx.xent_dx_saved_plain(e, mrun, w, tg, lse, dn, chunk),
                      cx.xent_dw_saved_plain(e, mrun, x, tg, lse, dn, chunk)),
                2e-2)
    assert torch.equal(cx.xent_dx_saved(e, mrun, w, tg, lse, dn), got[0])
    assert torch.equal(cx.xent_dw_saved(e, mrun, x, tg, lse, dn), got[1])


# The bf16 forward and the matmul backward's g (B9, B11: one body, a
# persistent CTA an SM, 128-token x 256-column logits tiles on wgmma, 64
# wide contraction steps, the bf16 tile stored by TMA) at shapes off
# every edge of that tile: T 300 and 1000 (off 128), V 1000 (off the 256
# tile and the 128-column chunk) and 4104 (off both, one chunk of 8
# columns), D 136, 520 and 2176 (off the 64-wide step), and the base
# step's head. lse, the target logit and mrun within 1e-3 (bf16 products
# summed in float32 in another order), e (with save) and g within 2e-2
# of the largest entry (bf16 rounding); save on and off give the same
# lse bit for bit, and a second call the same bits.
@pytest.mark.parametrize("t,d,v", [(300, 136, 1000), (1000, 520, 4104),
                                   (300, 2176, 4104), (1000, 136, 1000),
                                   (300, 520, 1000), (8192, 1024, 32768)])
def test_xent_fwd_and_g_bf16_match_plain(t, d, v, no_tf32):
    gen = no_tf32
    x = _randn((t, d), torch.bfloat16, gen)
    w = (torch.randn((v, d), generator=gen, device="cuda")
         * d ** -0.5).to(torch.bfloat16)
    tg = torch.randint(0, v, (t,), generator=gen, device="cuda",
                       dtype=torch.int32)
    dn = torch.randn((t,), generator=gen, device="cuda") / t
    chunk = cx.TILE[torch.bfloat16]
    cx.reset_launches()
    lse, tgt, e, mrun = cx.xent_fwd(x, w, tg, save=True)
    lse0, tgt0 = cx.xent_fwd(x, w, tg, save=False)
    g = cx.xent_g(x, w, tg, lse, dn)
    assert cx.LAUNCHES["xent_fwd"] == 2 and cx.LAUNCHES["xent_g"] == 1
    plse, ptgt, pe, pm = cx.xent_fwd_plain(x, w, tg, True, chunk)
    torch.testing.assert_close(lse, plse, atol=1e-3, rtol=0)
    torch.testing.assert_close(tgt, ptgt, atol=1e-3, rtol=0)
    assert torch.equal(lse0, lse) and torch.equal(tgt0, tgt)
    assert e.shape == (t, v) and e.dtype == torch.bfloat16
    assert mrun.shape == pm.shape
    torch.testing.assert_close(mrun, pm, atol=1e-3, rtol=0)
    _grad_close((e, g), (pe, cx.xent_g_plain(x, w, tg, lse, dn)), 2e-2)
    assert torch.equal(cx.xent_g(x, w, tg, lse, dn), g)
    again = cx.xent_fwd(x, w, tg, save=True)
    assert all(torch.equal(a, b) for a, b in zip(again, (lse, tgt, e, mrun)))


# The fused head in the matmul backward's recompute flavour (B9's forward,
# B11's g, then two products) at a shape off the logits tile that JAX's
# gate takes: its loss and gradients against the plain versions (the
# gradients within 2e-2 of the largest entry: g is rounded to bf16).
def test_fused_head_matmul_recompute_bf16_matches_plain(no_tf32):
    from icikit_torch.ops.xent import fused_xent, xent_supported

    gen = no_tf32
    t, d, v = 300, 640, 1000
    assert xent_supported(t, d, v, torch.bfloat16)
    x = _randn((t, d), torch.bfloat16, gen)
    w = (torch.randn((v, d), generator=gen, device="cuda")
         * d ** -0.5).to(torch.bfloat16)
    tg = torch.randint(0, v, (t,), generator=gen, device="cuda",
                       dtype=torch.int32)
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    cx.reset_launches()
    loss = fused_xent(xg, wg, tg, save_exp=False, fused_bwd=False)
    loss.sum().backward()
    assert {k: n for k, n in cx.LAUNCHES.items() if n} == {"xent_fwd": 1,
                                                          "xent_g": 1}
    plse, ptgt = cx.xent_fwd_plain(x, w, tg, False)
    torch.testing.assert_close(loss, plse - ptgt, atol=1e-3, rtol=0)
    ones = torch.ones((t,), device="cuda")
    _grad_close((xg.grad, wg.grad),
                (cx.xent_dx_plain(x, w, tg, plse, ones),
                 cx.xent_dw_plain(x, w, tg, plse, ones)), 2e-2)


# Past D 2048 (one cluster of 8 CTAs, 256 columns each) the bf16
# recompute flavour walks chunks (cuda_xent.recompute_walk: a chunk's g by
# xent_g_bf16, then its product by xent_dx_g_bf16 / xent_dw_g_bf16), at
# the same tolerance, at shapes off every chunk edge: dx in 4 x 72 + 12
# tokens and dw in 4 x 248 + 8 vocabulary rows at (300, 2176, 1000); 4 x
# 64 tokens and 4 x 128 rows at (256, 4096, 512); 4 x 272 + 12 and 4 x
# 1024 + 8 at (1100, 4096, 4104); 4 x 64 and 4 x 128 + 8 at (256, 8192,
# 520) (T, V off the 128-row tiles and 64-wide steps, an odd step count,
# D 2176 off the 256-column slices), with the true lse and with lse less
# log V (where g's softmax part outweighs the -dnll at a row's target);
# the fused head's recompute flavour keeps its route there, as JAX's gate
# decides.
@pytest.mark.parametrize("t,d,v", [(300, 2176, 1000), (256, 4096, 512),
                                   (1100, 4096, 4104), (256, 8192, 520)])
def test_xent_recompute_bf16_past_one_cluster_matches_plain(t, d, v,
                                                            no_tf32):
    import math

    from icikit_torch.ops.xent import fused_xent, xent_supported

    gen = no_tf32
    x = _randn((t, d), torch.bfloat16, gen)
    w = (torch.randn((v, d), generator=gen, device="cuda")
         * d ** -0.5).to(torch.bfloat16)
    tg = torch.randint(0, v, (t,), generator=gen, device="cuda",
                       dtype=torch.int32)
    dn = torch.randn((t,), generator=gen, device="cuda") / t
    lse, _ = cx.xent_fwd(x, w, tg, save=False)
    for ls in (lse, lse - math.log(v)):
        cx.reset_launches()
        got = (cx.xent_dx(x, w, tg, ls, dn), cx.xent_dw(x, w, tg, ls, dn))
        assert cx.LAUNCHES["xent_dx"] == cx.LAUNCHES["xent_dw"] == 1
        _grad_close(got, (cx.xent_dx_plain(x, w, tg, ls, dn),
                          cx.xent_dw_plain(x, w, tg, ls, dn)), 2e-2)
    if t % 128 == 0:
        assert xent_supported(t, d, v, torch.bfloat16)
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        cx.reset_launches()
        fused_xent(xg, wg, tg, save_exp=False, fused_bwd=True).sum(
        ).backward()
        assert cx.LAUNCHES["xent_dx"] == cx.LAUNCHES["xent_dw"] == 1
        ones = torch.ones_like(dn)
        lse, _ = cx.xent_fwd(x, w, tg, save=False)
        _grad_close((xg.grad, wg.grad),
                    (cx.xent_dx_plain(x, w, tg, lse, ones),
                     cx.xent_dw_plain(x, w, tg, lse, ones)), 2e-2)


# The walk's two pieces alone, bf16: a vocabulary chunk's g (targets in
# absolute units, some inside the chunk and some outside it, the chunk's
# last 256-column tile ragged) against g_cols_plain within 2e-2 of its
# largest entry, once with the true lse (the -dnll at a row's target
# dominates g) and once with lse less log V (the softmax part, V times
# larger, dominates); then the products with that dense g given (an odd
# and an even step count, rows off the 128-row tile) against
# g_product_plain on the same bf16 g within 2e-2; the same bits from call
# to call.
@pytest.mark.parametrize("t,d,v0,vc", [(300, 2176, 264, 520),
                                       (1000, 4096, 1024, 1000)])
def test_xent_recompute_walk_pieces_match_plain(t, d, v0, vc, no_tf32):
    import math

    gen = no_tf32
    v = v0 + vc + 64
    x = _randn((t, d), torch.bfloat16, gen)
    w = (torch.randn((v, d), generator=gen, device="cuda")
         * d ** -0.5).to(torch.bfloat16)
    tg = torch.randint(0, v, (t,), generator=gen, device="cuda",
                       dtype=torch.int32)
    dn = torch.randn((t,), generator=gen, device="cuda") / t
    lse, _ = cx.xent_fwd(x, w, tg, save=False)
    lib = _build.load("xent")
    wc = w[v0:v0 + vc]
    scratch = torch.empty(t * vc, dtype=torch.bfloat16, device="cuda")
    g_piece, product = cx.card_pieces(lib, x, scratch)
    for shift in (0.0, math.log(v)):
        ls = lse - shift
        g = g_piece(x, wc, tg, ls, dn, v0).clone()
        want = cx.g_cols_plain(x, wc, tg, ls, dn, v0)
        _grad_close((g,), (want,), 2e-2)
        assert torch.equal(g_piece(x, wc, tg, ls, dn, v0), g)
    for which, op, rows in (("dx", wc, t), ("dw", x, vc)):
        out, ref = (torch.empty((rows, d), dtype=torch.bfloat16,
                                device="cuda") for _ in range(2))
        product(which, g, op, out)
        cx.g_product_plain(which, g, op, ref)
        _grad_close((out,), (ref,), 2e-2)
        again = torch.empty_like(out)
        product(which, g, op, again)
        assert torch.equal(again, out)


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


def _tree(sizes, grads, mom, gen, offset=0, vmom=None):
    """Leaves of ``sizes`` with gradients of ``grads`` in turn, as views
    ``offset`` elements into their buffers; v in ``vmom`` if given, else
    in m's ``mom``."""
    out = []
    for i, n in enumerate(sizes):
        def mk(dtype, scale, n=n):
            t = scale * torch.randn(n + offset, generator=gen, device="cuda")
            return (t.abs() if scale == 0.01 else t).to(dtype)[offset:]
        out.append((mk(torch.float32, 1.0), mk(mom, 0.1),
                    mk(vmom or mom, 0.01), mk(grads[i % len(grads)], 1.0)))
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


@pytest.mark.parametrize("m_dtype,v_dtype", [
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)])
def test_adam_tree_with_mixed_moments_matches_plain_bitwise(m_dtype,
                                                           v_dtype, gen):
    """Moments of two dtypes (FusedAdam's float32 m and bf16 v, and the
    reverse): one launch over the tree, heads and tails included, bit
    for bit with the plain version; a tree holding all four (m, v) pairs
    takes one launch a pair."""
    from icikit_torch.ops.adam import adam_scalars

    sc = adam_scalars(3e-3, torch.tensor(7, device="cuda"))
    grads = (torch.bfloat16, torch.float32, torch.float16)
    leaves = [a + b for a, b in zip(
        _tree((1, 7, 1000, (1 << 20) + 3), grads, m_dtype, gen,
              vmom=v_dtype),
        _tree((5000,), grads, m_dtype, gen, offset=1, vmom=v_dtype))]
    ref = [[t.clone() for t in ts] for ts in leaves[:3]]
    cuda_adam.reset_launches()
    cuda_adam.adam_tree(*leaves, sc, 0.9, 0.999, 1e-8)
    assert cuda_adam.LAUNCHES["adam"] == 1
    cuda_adam.adam_tree_plain(*ref, leaves[3], sc, 0.9, 0.999, 1e-8)
    for got, want in zip(leaves[:3], ref):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    f32, bf = torch.float32, torch.bfloat16
    leaves = [sum(ts, []) for ts in zip(*(
        _tree((3000, 9), grads, m, gen, vmom=v)
        for m, v in ((f32, f32), (bf, f32), (f32, bf), (bf, bf))))]
    ref = [[t.clone() for t in ts] for ts in leaves[:3]]
    cuda_adam.reset_launches()
    cuda_adam.adam_tree(*leaves, sc, 0.9, 0.999, 1e-8)
    assert cuda_adam.LAUNCHES["adam"] == 4
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


# The int8 decode path's products (N, K) at base
Q8_PATH_SHAPES = [(3072, 1024), (1024, 1024), (4096, 1024), (1024, 4096),
                  (32768, 1024)]


@pytest.mark.parametrize("rows", [1, 2, 8, 16])
@pytest.mark.parametrize("n,k", Q8_PATH_SHAPES)
@pytest.mark.parametrize("cpw_max", [None, 1])
def test_quant_matvec_skinny_at_the_path_shapes(rows, n, k, cpw_max,
                                                no_tf32, monkeypatch):
    """The skinny kernel (bf16, rows <= 16) at the int8 path's five
    products: with the picker's splits (none up to K 4096 at rows 8, two
    at K 4096 and rows 16) and with one chunk a warp at most, which
    splits K 1024 in 2 and K 4096 in 8 across CTAs, each tile's splits
    added by its last CTA in the same launch: within 1e-4 of the largest
    plain entry, the same bits from call to call, the tile counters left
    at zero."""
    if cpw_max:
        monkeypatch.setattr(cq, "SKINNY_CPW_MAX", cpw_max)
        monkeypatch.setattr(cq, "SKINNY_CPW_MAX_NT2", cpw_max)
    gen = no_tf32
    x = _randn((rows, k), torch.bfloat16, gen)
    w8 = torch.randint(-128, 128, (n, k), generator=gen, device="cuda",
                       dtype=torch.int8)
    sc = torch.rand((n,), generator=gen, device="cuda") / 127
    cq.reset_launches()
    got = cq.quant_matvec(x, w8, sc)
    assert cq.LAUNCHES["quant_matvec"] == 1
    want = cq.quant_matvec_plain(x, w8, sc)
    torch.testing.assert_close(got, want, rtol=0, atol=QMV_TOL[torch.bfloat16]
                               * float(want.abs().max()))
    for _ in range(3):
        assert torch.equal(cq.quant_matvec(x, w8, sc), got)
    if cpw_max:
        assert cq.skinny_splits(rows, k) == k // 64 // 8
    if cq.skinny_splits(rows, k) > 1:
        _, counter = _build.split_scratch(x, "quant_matvec", 0, 0)
        assert int(counter.abs().sum()) == 0


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


# The prefill's products (N, K) at base, and N 384 (three 128-channel
# tiles, not a multiple of 256), at rows on and off the tile kernel's
# 256-row tile: 17 (one short tile), 300, 4095 (the last tile cut short
# by one) and 4096.
Q8_PREFILL_SHAPES = [(3072, 1024), (1024, 1024), (4096, 1024), (1024, 4096),
                     (384, 1024)]


@pytest.mark.parametrize("rows", [17, 300, 4095, 4096])
@pytest.mark.parametrize("n,k", Q8_PREFILL_SHAPES)
def test_quant_matvec_tile_at_the_prefill_shapes(rows, n, k, no_tf32):
    """The tile kernel (bf16, rows > 16: wgmma, the int8 widened in
    registers, a TMA ring): within 1e-4 of the largest plain entry, the
    same bits from call to call."""
    gen = no_tf32
    x = _randn((rows, k), torch.bfloat16, gen)
    w8 = torch.randint(-128, 128, (n, k), generator=gen, device="cuda",
                       dtype=torch.int8)
    sc = torch.rand((n,), generator=gen, device="cuda") / 127
    cq.reset_launches()
    got = cq.quant_matvec(x, w8, sc)
    assert cq.LAUNCHES["quant_matvec"] == 1 and got.shape == (rows, n)
    want = cq.quant_matvec_plain(x, w8, sc)
    torch.testing.assert_close(got, want, rtol=0, atol=QMV_TOL[torch.bfloat16]
                               * float(want.abs().max()))
    for _ in range(2):
        assert torch.equal(cq.quant_matvec(x, w8, sc), got)


def test_quant_matvec_tile_refuses_n_off_its_channel_tile(gen):
    """At bf16 and rows > 16 the wrapper refuses an N that is not a
    multiple of the tile's 128 channels, by name and before any launch
    (JAX's gate never sends one); the skinny kernel (rows <= 16) and the
    float32 kernel still take N a multiple of 64."""
    x = _randn((32, 128), torch.bfloat16, gen)
    w8 = torch.randint(-127, 128, (192, 128), generator=gen, device="cuda",
                       dtype=torch.int8)
    sc = torch.rand((192,), generator=gen, device="cuda") / 127
    cq.reset_launches()
    with pytest.raises(ValueError, match="multiple of 128"):
        cq.quant_matvec(x, w8, sc)
    assert cq.LAUNCHES["quant_matvec"] == 0
    for xi in (x[:16].contiguous(), x.float()):
        want = cq.quant_matvec_plain(xi, w8, sc)
        torch.testing.assert_close(cq.quant_matvec(xi, w8, sc), want,
                                   rtol=0, atol=QMV_TOL[xi.dtype] * float(
                                       want.abs().max()))
    assert cq.LAUNCHES["quant_matvec"] == 2


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


@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [128, 256])
@pytest.mark.parametrize("cur", [0, 1, 127, 128, 543, 575])
@pytest.mark.parametrize("ctas_per_sm", [None, 64])
def test_decode_step_q8_splits_match_plain(qdtype, dh, cur, ctas_per_sm,
                                           no_tf32, monkeypatch):
    """The int8 step split across CTAs at the int8 path's 64 rows and
    576 columns, with the picker's splits and with its splits for 64
    CTAs an SM (as many as cur allows: 33 splits of 17 columns at cur
    543, the last one empty): the output within 1e-5 of the plain
    version's, and the fresh column written once, bit for bit as the
    plain version writes it, the rest of the caches untouched."""
    from icikit_torch.ops.quant import dequantize_last, quantize_last

    if ctas_per_sm:
        monkeypatch.setattr(ca, "DECODE_CTAS_PER_SM", ctas_per_sm)
    gen = no_tf32
    rows, total = 64, 576
    q = _randn((rows, dh), qdtype, gen)
    kq, ks = quantize_last(_randn((rows, dh), torch.float32, gen))
    vq, vs = quantize_last(_randn((rows, dh), torch.float32, gen))
    kc, kcs = quantize_last(_randn((rows, total, dh), torch.float32, gen))
    vc, vcs = quantize_last(_randn((rows, total, dh), torch.float32, gen))
    kcs[:, cur], vcs[:, cur] = ks, vs
    kc0, vc0 = kc.clone(), vc.clone()
    kc2, vc2 = kc.clone(), vc.clone()
    args = (kq, vq, dequantize_last(kq, ks), dequantize_last(vq, vs))
    want = ca.decode_step_q8_plain(q, *args, kc2, vc2, kcs, vcs, cur,
                                   scale=dh ** -0.5)
    ca.reset_launches()
    got = ca.decode_step_q8(q, *args, kc, vc, kcs, vcs, cur,
                            scale=dh ** -0.5)
    assert ca.LAUNCHES["decode_step_q8"] == 1
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert torch.equal(kc, kc2) and torch.equal(vc, vc2)
    assert torch.equal(kc[:, cur], kq) and torch.equal(vc[:, cur], vq)
    keep = torch.arange(total, device="cuda") != cur
    assert torch.equal(kc[:, keep], kc0[:, keep])
    assert torch.equal(vc[:, keep], vc0[:, keep])
    # a second call on the same workspace gives the same bits
    again = ca.decode_step_q8(q, *args, kc, vc, kcs, vcs, cur,
                              scale=dh ** -0.5)
    assert torch.equal(got, again)


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


@pytest.mark.parametrize("s", [128, 256, 384])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("variant", ["mxu", "softmax_ks1", "no_exp2",
                                     "no_max", "no_exp2_no_max"])
def test_tile_floor_kernels_match_plain(variant, d, s, no_tf32):
    """Each B17 kernel against its plain version at one, two and three
    128-key tiles (the ring's first pass, and its stages reused after an
    even and an odd count), and refusing a length off the tile."""
    from icikit_torch.bench.tile_floor import ABLATIONS
    from icikit_torch.ops import cuda_tile_floor as ctf

    gen = no_tf32
    q, k, v = (_randn((1, 2, s, d), torch.bfloat16, gen)
               for _ in range(3))
    sl2 = d ** -0.5 * 1.442695
    ctf.reset_launches()
    if variant == "mxu":
        got, want = ctf.tile_mxu(q, k, v, sl2), ctf.mxu_plain(q, k, v, sl2)
        assert ctf.LAUNCHES == {"tile_mxu": 1, "tile_ablate": 0}
    else:
        flags = {n: (e, m) for n, e, m in ABLATIONS}[variant]
        got = ctf.tile_ablate(q, k, v, sl2, *flags)
        want = ctf.ablate_plain(q, k, v, sl2, *flags)
        assert ctf.LAUNCHES == {"tile_mxu": 0, "tile_ablate": 1}
    err = float((got.float() - want.float()).abs().max())
    assert err <= 2e-2 * float(want.float().abs().max())
    with pytest.raises(ValueError, match="head dims"):
        ctf.tile_mxu(*(t[..., :32].contiguous() for t in (q, k, v)), sl2)
    with pytest.raises(ValueError, match="multiple of the tiles"):
        ctf.tile_mxu(*(t[:, :, :64].contiguous() for t in (q, k, v)), sl2)


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


# -- the checked transport's checksum (integrity.cu) --------------------

from icikit_torch.ops import cuda_integrity as ci  # noqa: E402

CHECKSUM_DTYPES = (torch.uint8, torch.int8, torch.bool, torch.int16,
                   torch.bfloat16, torch.float16, torch.int32,
                   torch.float32, torch.int64, torch.float64)


def _rows_at(gen, p, n, dtype, offset):
    """(p, n) random bits of ``dtype`` starting ``offset`` bytes into a
    fresh buffer (0/1 bytes for bool)."""
    width = torch.empty((), dtype=dtype).element_size()
    buf = torch.randint(0, 2 if dtype == torch.bool else 256,
                        (p * n * width + offset,), generator=gen,
                        dtype=torch.uint8, device="cuda")
    return buf[offset:].view(dtype).view(p, n)


@pytest.mark.parametrize("dtype", CHECKSUM_DTYPES)
@pytest.mark.parametrize("p,n", [(1, 0), (1, 1), (3, 33), (2, 4096),
                                 (8, (1 << 16) + 3), (1, 1 << 20)])
@pytest.mark.parametrize("misaligned", [False, True])
def test_segment_checksum_matches_plain_bitwise(dtype, p, n, misaligned,
                                                gen):
    """Both load paths (16-byte words on an aligned base whose rows are
    multiples of 16 bytes, elements otherwise), odd n, n = 0 (a zero
    fold and no launch) and p = 1, bit for bit against the plain fold."""
    width = torch.empty((), dtype=dtype).element_size()
    x = _rows_at(gen, p, n, dtype, width if misaligned else 0)
    ci.reset_launches()
    got = ci.segment_checksum(x)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (p,)
    assert torch.equal(got, ci.segment_checksum(x, plain=True))
    assert ci.LAUNCHES["segment_checksum"] == (1 if n else 0)
    if n == 0:
        assert not bool(got.any())


def test_segment_checksum_catches_every_flip_of_a_row(gen):
    """One flipped bit in any of a row's 4096 int32 lanes changes only
    that row's fold."""
    x = _rows_at(gen, 4, 4096, torch.int32, 0)
    clean = ci.segment_checksum(x)
    for i in (0, 1, 31, 32, 4095):
        for bit in (0, 17, 31):
            y = x.clone()
            y[2, i] ^= (1 << bit) if bit < 31 else -(1 << 31)
            f = ci.segment_checksum(y)
            assert not torch.equal(f[2], clean[2])
            assert torch.equal(f[[0, 1, 3]], clean[[0, 1, 3]])


def test_checked_collectives_and_sort_on_the_card(gen):
    """The checked transport on CUDA tensors: outputs equal the
    unchecked ones, a scheduled drill is detected and recovered, and the
    folds go through the kernel (two an exchange)."""
    from icikit_torch import chaos
    from icikit_torch import parallel as tp
    from icikit_torch.models.sort import sort
    from icikit_torch.parallel import integrity
    from icikit_torch.utils.mesh import make_mesh

    mesh = make_mesh(8, device="cuda")
    x = torch.randn((8, 1000), generator=gen, device="cuda")
    ci.reset_launches()
    got = tp.all_reduce(x, mesh, algorithm="ring", checked=True)
    assert torch.equal(got, tp.all_reduce(x, mesh, algorithm="ring"))
    assert ci.LAUNCHES["segment_checksum"] == 2 * 14
    integrity.reset_stats()
    plan = chaos.FaultPlan(seed=1,
                           schedule={"corrupt:collective.allgather": (0,)})
    with chaos.inject(plan):
        healed = tp.all_gather_blocks(x, mesh, algorithm="ring",
                                      checked=True)
    assert torch.equal(healed, tp.all_gather_blocks(x, mesh))
    assert integrity.stats()["recoveries"] == 1
    keys = torch.randint(-2**31, 2**31 - 1, (1 << 18,), generator=gen,
                         dtype=torch.int32, device="cuda")
    ci.reset_launches()
    assert torch.equal(sort(keys, mesh, checked=True),
                       torch.sort(keys).values)
    assert ci.LAUNCHES["segment_checksum"] == 12


# -- the peg-solitaire DFS (solitaire.cu) ---------------------------------

from icikit_torch.ops import cuda_solitaire as cso  # noqa: E402

# tests/test_solitaire.py's edge boards: one peg, empty, full, three in a
# row, domino, 2x2 square, the domino's escape hole NA
SOLITAIRE_EDGES = ("1" + "0" * 24, "0" * 25, "1" * 25, "111" + "0" * 22,
                   "110" + "0" * 22, "11000" * 2 + "0" * 15,
                   "112" + "0" * 22)


def _boards_on_card(batch, dtype=torch.uint32):
    import numpy as np
    out = []
    for a in (batch.pegs, batch.playable):
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).cuda()
        out.append(t.view(torch.uint32) if dtype == torch.uint32
                   else t.to(torch.int64) & 0xFFFFFFFF)
    return out


def _same(a, b):
    return all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("max_steps", [0, 1, 3, 2000, 2_000_000_000])
def test_solve_dfs_edge_boards_match_plain(max_steps, gen):
    from icikit_torch.models.solitaire.game import (BoardBatch,
                                                    solve_batch_plain)
    pg, pl = _boards_on_card(BoardBatch.from_strings(list(SOLITAIRE_EDGES)))
    cso.reset_launches()
    got = cso.solve_dfs(pg, pl, max_steps)
    assert cso.LAUNCHES["solve_dfs"] == 1
    assert _same(got, solve_batch_plain(pg, pl, max_steps))


@pytest.mark.parametrize("grade,n,max_steps", [
    ("easy", 512, 2000), ("medium", 256, 2000), ("hard", 64, 1500),
    ("easy", 300, 1), ("medium", 100, 3)])
def test_solve_dfs_graded_boards_match_plain(grade, n, max_steps, gen):
    from icikit_torch.models.solitaire.dataset import generate_dataset
    from icikit_torch.models.solitaire.game import (solve_batch,
                                                    solve_batch_plain)
    pg, pl = _boards_on_card(generate_dataset(n, grade, seed=1))
    got = solve_batch(pg, pl, max_steps)
    assert _same(got, solve_batch_plain(pg, pl, max_steps))
    # int64 masks take the same launch
    p64, q64 = _boards_on_card(generate_dataset(n, grade, seed=1),
                               torch.int64)
    assert _same(solve_batch(p64, q64, max_steps), got)


def test_solve_dfs_any_bits_match_plain(gen):
    """Masks with bits past the 25 cells and pegs off the playable cells
    follow JAX's rules too."""
    pg = torch.randint(-2**31, 2**31 - 1, (777,), generator=gen,
                       dtype=torch.int32, device="cuda")
    pl = torch.randint(-2**31, 2**31 - 1, (777,), generator=gen,
                       dtype=torch.int32, device="cuda")
    from icikit_torch.models.solitaire.game import solve_batch_plain
    for a, b in ((pg, pl), (pg & pl & 0x1FFFFFF, pl)):
        got = cso.solve_dfs(a, b, 3000)
        assert _same(got, solve_batch_plain(a, b, 3000))


def test_solve_dfs_empty_batch_launches_nothing(gen):
    e = torch.zeros(0, dtype=torch.uint32, device="cuda")
    cso.reset_launches()
    out = cso.solve_dfs(e, e, 10)
    assert cso.LAUNCHES["solve_dfs"] == 0
    assert out[2].shape == (0, 25) and out[0].dtype == torch.bool


def test_solve_dfs_schedulers_on_streams(gen):
    """Eight workers on the card (eight streams) agree with the native
    host solver board for board."""
    from icikit_torch.models.solitaire.dataset import generate_skewed_dataset
    from icikit_torch.models.solitaire.scheduler import (solve_dynamic,
                                                         solve_host,
                                                         solve_static)
    ds = generate_skewed_dataset(128, seed=3, hard_fraction=0.25)
    host = solve_host(ds, max_steps=200_000)
    for rep in (solve_static(ds, devices=["cuda"] * 8, max_steps=200_000),
                solve_dynamic(ds, devices=["cuda"] * 8, chunk_size=4,
                              max_steps=200_000)):
        assert (rep.solved == host.solved).all()
        assert (rep.steps == host.steps).all()
        assert (rep.moves == host.moves).all()


@pytest.fixture(scope="module")
def capped_hard():
    """256 hard boards (seed 0), the native solver's outputs at 500,000
    steps, and the indices of the boards that hit the cap."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import numpy as np
    from icikit_torch.models.solitaire.dataset import generate_dataset
    from icikit_torch.models.solitaire.scheduler import solve_host
    ds = generate_dataset(256, "hard", seed=0)
    host = solve_host(ds, max_steps=500_000)
    return ds, host, np.flatnonzero(host.steps >= 500_000)


def _host_rows(host, idx):
    import numpy as np
    return [np.asarray(x)[idx] for x in (host.solved, host.n_moves,
                                         host.moves, host.steps,
                                         host.status)]


@pytest.mark.parametrize("lanes", [1, 32])
def test_solve_dfs_capped_lanes_match_host(lanes, capped_hard, gen):
    """A lone capped board (a one-board launch) and a warp of 32 capped
    hard boards, at the study's budget, bit for bit the host's."""
    ds, host, capped = capped_hard
    assert len(capped) >= lanes
    idx = capped[:lanes]
    pg, pl = _boards_on_card(ds[idx])
    got = [x.cpu().numpy() for x in cso.solve_dfs(pg, pl, 500_000)]
    want = _host_rows(host, idx)
    for g, w in zip(got, want):
        assert (g == w).all()
    assert (got[3] == 500_000).all() and (got[4] == 3).all()


@pytest.mark.parametrize("n", [77, 100, 129])
def test_solve_dfs_tail_lanes_match(n, capped_hard, gen):
    """A batch that fills no whole warp or block: the lanes past n stay
    in the loop stopped, the warps leave by their vote. Held to the host
    at the study's budget and to the plain version at a small one."""
    from icikit_torch.models.solitaire.game import solve_batch_plain
    ds, host, _ = capped_hard
    idx = list(range(n))
    pg, pl = _boards_on_card(ds[idx])
    got = [x.cpu().numpy() for x in cso.solve_dfs(pg, pl, 500_000)]
    for g, w in zip(got, _host_rows(host, idx)):
        assert (g == w).all()
    assert _same(cso.solve_dfs(pg, pl, 1500), solve_batch_plain(pg, pl, 1500))


@pytest.mark.parametrize("max_steps", [0, 3000])
def test_solve_dfs_refills_lanes_past_one_wave(max_steps, gen):
    """More boards than two blocks an SM hold: each lane takes its
    block's next board when one stops (none steps at a zero budget).
    Held to the host solver board for board."""
    import numpy as np
    from icikit_torch.models.solitaire.dataset import generate_dataset
    from icikit_torch.models.solitaire.scheduler import solve_host
    n = 2 * 64 * _build.sm_count(torch.device("cuda")) + 1234
    ds = generate_dataset(n, "easy", seed=5)
    host = solve_host(ds, max_steps=max_steps)
    pg, pl = _boards_on_card(ds)
    got = [x.cpu().numpy() for x in cso.solve_dfs(pg, pl, max_steps)]
    for g, w in zip(got, _host_rows(host, np.arange(n))):
        assert (g == w).all()


# -- the multi-process layer (hierarchical collectives, two processes) -


_HIER_CASES = (
    [("allreduce", {"ici_algorithm": a})
     for a in ("ring", "recursive_doubling", "xla")]
    + [("allreduce", {"dcn_algorithm": "recursive_doubling"}),
       ("allreduce", {"op": "max"}),
       ("allgather", {}), ("allgather", {"ici_algorithm": "xla",
                                         "dcn_algorithm": "xla"}),
       ("reducescatter", {}), ("reducescatter", {"op": "min"}),
       ("alltoall", {}), ("alltoall", {"ici_algorithm": "hypercube",
                                       "dcn_algorithm": "wraparound"})])


@pytest.mark.parametrize("dcn,ici", [(2, 4), (4, 2)])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("coll,kw", _HIER_CASES)
def test_hierarchical_collectives_on_the_card_equal_the_cpu_run(
        coll, kw, dtype, dcn, ici, gen):
    """Each hierarchical collective on CUDA tensors equals the same call
    on the CPU bit for bit (its tiers' schedules combine in one order on
    either device); a float32 sum through an ``xla`` tier (torch's own
    reduction, which adds p terms in the device's order) within the
    bound of two orders, 2 (p - 1) 2^-24 sum|x|."""
    from icikit_torch import parallel as tp
    p, m = dcn * ici, 1 << 14
    shape = (p, p, m // p) if coll == "alltoall" else (p, m)
    x = (torch.randn(shape, generator=gen, device="cuda")
         if dtype == torch.float32 else
         torch.randint(-1000, 1000, shape, generator=gen, dtype=dtype,
                       device="cuda"))
    fn = getattr(tp, {"allreduce": "hierarchical_all_reduce",
                      "allgather": "hierarchical_all_gather",
                      "reducescatter": "hierarchical_reduce_scatter",
                      "alltoall": "hierarchical_all_to_all"}[coll])
    got = fn(x, tp.make_hybrid_mesh(dcn, ici, device="cuda"), **kw)
    want = fn(x.cpu(), tp.make_hybrid_mesh(dcn, ici, device="cpu"), **kw)
    assert got.is_cuda
    got = got.cpu()
    if (dtype == torch.float32 and coll == "allreduce" and "op" not in kw
            and "xla" in kw.values()):
        bound = 2 * (p - 1) * 2.0**-24 * x.cpu().abs().sum(0)
        assert ((got - want).abs() <= bound).all()
    else:
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_two_process_bitonic_sort_on_the_card(gen, tmp_path):
    """Two processes share the card (gloo, staged through host), four
    ranks each, and sort 2^20 int32 keys through the sort kernels: each
    process's rows equal the one-process sort's, bit for bit, with 0
    inversions and both kernels launched in each process."""
    import hashlib
    import os

    import numpy as np

    from icikit_torch.examples import multihost as mh
    from icikit_torch.models.sort import sort
    from icikit_torch.utils.mesh import make_mesh

    log2n, m = 20, 64
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    keys = torch.from_numpy(mh.inputs(m, log2n)["keys"]).cuda()
    out = sort(keys, make_mesh(mh.RANKS, device="cuda")).view(mh.RANKS, -1)
    half = mh.RANKS // mh.PROCESSES
    digests = [hashlib.sha256(out[i * half:(i + 1) * half].cpu().numpy()
                              .tobytes()).hexdigest()
               for i in range(mh.PROCESSES)]
    env = dict(os.environ, PYTHONPATH=root)
    res = mh.launch(mh.worker_argv("cuda", str(tmp_path), m, log2n,
                                   keep_sorted=False),
                    str(tmp_path), timeout=180, env=env, cwd=root)
    for code, text in res:
        assert code == 0 and "WORKER_OK" in text, text[-3000:]
    recs = [mh.worker_result(text) for _, text in res]
    assert [r["sha256"] for r in recs] == digests
    assert all(r["inversions"] == 0 for r in recs)
    assert all(r["launches"]["net"] > 0 and r["launches"]["cross"] > 0
               for r in recs)
    assert all(r["wire"]["bytes_sent"] == half * (1 << log2n) // mh.RANKS
               * 4 for r in recs)
    rows = [np.load(tmp_path / f"rank{i}.npz") for i in range(2)]
    assert set(rows[0]) == set(rows[1])


# ------------------------------------------- threefry on the card (A9)
# utils/threefry.py's integer arithmetic must give the CPU's words on the
# card bit for bit: key data, folds and bits, hence the uniforms; the
# sampled generate's draws depend on nothing else but the Gumbel log.


@pytest.mark.parametrize("shape", [(7,), (3, 1000), (32768,)])
def test_threefry_on_the_card_equals_the_cpu(shape, gen):
    from icikit_torch.models.transformer import decode as td
    from icikit_torch.utils import threefry as tf

    key = tf.key_data(5)
    seeds = torch.tensor([0, 1, -1, 2**31 - 1, -2**31], dtype=torch.int32)
    pos = 512 + torch.arange(5 * 4).reshape(5, 4)
    keys = {d: td.fold_positions(td.fold_streams(key.to(d), seeds.to(d)),
                                 pos.to(d)) for d in ("cpu", "cuda")}
    assert torch.equal(keys["cuda"].cpu(), keys["cpu"])
    for fn in (tf.random_bits, tf.uniform):
        assert torch.equal(fn(keys["cuda"], shape).cpu(),
                           fn(keys["cpu"], shape))
    g = {d: tf.gumbel(keys[d], shape) for d in keys}
    assert float((g["cuda"].cpu() - g["cpu"]).abs().max()) <= 1e-6


def test_select_tokens_on_the_card_equals_the_cpu_up_to_near_ties(gen):
    """A sampled draw (the filter, the keys, the Gumbel argmax) on the
    card gives the CPU's token except where the CPU's top-2 gap of
    Gumbel plus filtered logits is below 1e-5 (the two devices' log
    round apart)."""
    from icikit_torch.models.transformer import decode as td
    from icikit_torch.utils import threefry as tf

    lg = torch.randn((64, 32768), generator=gen, device="cuda")
    keys = tf.fold_in(tf.key_data(1, "cuda"), torch.arange(64,
                                                           device="cuda"))
    knobs = torch.tensor([0.8, 0.9, 40.0], device="cuda")
    got = td.select_tokens(lg, keys, knobs).cpu()
    want = td.select_tokens(lg.cpu(), keys.cpu(), knobs.cpu())
    x = td._sample_filter(lg.cpu(), knobs[0].cpu().expand(64),
                          knobs[2].cpu().expand(64),
                          knobs[1].cpu().expand(64))
    top = (tf.gumbel(keys.cpu(), (32768,)) + x).topk(2, dim=-1).values
    gap = top[:, 0] - top[:, 1]
    assert bool(((got == want) | (gap < 1e-5)).all())
