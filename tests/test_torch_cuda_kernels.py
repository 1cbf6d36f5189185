"""icikit_torch's CUDA kernels against their plain versions, on the card.

The kernels have no CPU mode, so every test here skips without a CUDA
device. This file imports neither jax nor icikit, so it also runs where
only the port is installed:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py

Tolerance: exact for the sort kernels (integers bitwise, floats by
value); the attention kernels' tolerances stand above their tests.
``chip_smoke.py`` covers the main paths' full-size shapes.
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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("s,d", [(64, 128), (200, 128), (512, 64)])
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
def test_decode_step_matches_plain_and_writes_in_place(dtype, rope, cur,
                                                       no_tf32):
    gen = no_tf32
    rows, total, dh = 6, 96, 128
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
        ca.flash_fwd(q[..., :32].contiguous(), q[..., :32].contiguous(),
                     q[..., :32].contiguous(), True, 0.1)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        h = q.half()
        ca.flash_fwd(h, h, h, True, 0.1)
    assert ca.LAUNCHES["flash_fwd"] == 1
