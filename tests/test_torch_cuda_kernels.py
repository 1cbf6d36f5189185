"""icikit_torch's CUDA kernels against their plain versions, on the card.

The kernels have no CPU mode, so every test here skips without a CUDA
device. This file imports neither jax nor icikit, so it also runs where
only the port is installed:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py

Tolerance: exact (integers bitwise, floats by value). ``chip_smoke.py``
covers the main path's full-size shapes.
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
