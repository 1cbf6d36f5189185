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

``adam_apply(use_pallas=True)`` (each leaf through the one-pass kernel
B12; on the CPU its plain version) against JAX's ``use_pallas=True`` on
the (32, 128) leaf its Pallas kernel covers and the (24, 128) leaf its
sublane gate sends to XLA (``tests/test_optim.py``). JAX's Pallas kernel
contracts the moment updates into fused multiply-adds where its XLA form
and the port round each product (``tests/test_optim.py`` allows the
same): against it, params 1e-6 relative and 1e-7 absolute, float32
moments 1e-6 relative and 1e-7 absolute, bf16 moments one bf16 ulp at
the lower edge of a binade (2^-7 relative) and 1e-9 absolute (a moment
that cancels to about 0, where the FMA keeps a residue of ~1e-10).
Where JAX's gate takes XLA, the port's moments equal its bit for bit.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icikit.ops.adam import adam_apply as j_adam_apply
from icikit.ops.adam import adam_scalars as j_adam_scalars
from icikit_torch.interop import from_jax, opt_state_from_jax, to_jax
from icikit_torch.ops import cuda_adam
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


@pytest.mark.parametrize("rows", [32, 24])
@pytest.mark.parametrize("mom_dtype", ["float32", "bfloat16"])
def test_adam_kernel_route_matches_jax_pallas(rows, mom_dtype):
    from icikit.ops.adam import _use_pallas

    rng = np.random.default_rng(rows)
    mdt = jnp.dtype(mom_dtype)
    p = rng.normal(size=(rows, 128)).astype(np.float32)
    m = np.asarray(jnp.asarray(rng.normal(size=(rows, 128)) * 0.1, mdt))
    v = np.asarray(jnp.asarray(rng.random((rows, 128)) * 0.01, mdt))
    g = np.asarray(jnp.asarray(rng.normal(size=(rows, 128)), jnp.bfloat16))
    covered = _use_pallas(*(jnp.asarray(a) for a in (p, m, v, g)))
    assert covered == (rows == 32)  # bf16 gradients: rows % 16
    jp, jm, jv = j_adam_apply({"w": jnp.asarray(p)}, {"w": jnp.asarray(m)},
                              {"w": jnp.asarray(v)}, {"w": jnp.asarray(g)},
                              1e-3, jnp.int32(2), use_pallas=True)
    tp, tm, tv = ({"w": from_jax(a)} for a in (p, m, v))
    cuda_adam.reset_launches()
    adam_apply(tp, tm, tv, {"w": from_jax(g)}, 1e-3, 2, use_pallas=True)
    assert cuda_adam.LAUNCHES["adam"] == 0  # CPU: the plain version
    np.testing.assert_allclose(to_jax(tp["w"]), np.asarray(jp["w"]),
                               rtol=1e-6, atol=1e-7)
    for got, want in ((tm["w"], jm["w"]), (tv["w"], jv["w"])):
        assert got.dtype == (torch.float32 if mom_dtype == "float32"
                             else torch.bfloat16)
        got = to_jax(got).astype(np.float32)
        want = np.asarray(want).astype(np.float32)
        if not covered:
            np.testing.assert_array_equal(got, want)
        elif mom_dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-9)


def test_adam_apply_routes_every_floating_leaf_through_the_kernel():
    """``use_pallas=True`` sends the floating leaves, in the tree's
    order, to the kernel's wrapper in one call (no sublane gate) and
    leaves integer leaves alone."""
    calls = []
    real = cuda_adam.adam_tree

    def spy(ps, ms, vs, gs, *a, **k):
        calls.append([tuple(p.shape) for p in ps])
        return real(ps, ms, vs, gs, *a, **k)

    p = {"a": torch.ones(5), "i": torch.ones(2, dtype=torch.int32),
         "b": torch.ones((3, 7))}
    m = {k: torch.zeros_like(x) for k, x in p.items()}
    v = {k: torch.zeros_like(x) for k, x in p.items()}
    try:
        cuda_adam.adam_tree = spy
        adam_apply(p, m, v, {k: torch.ones_like(x) for k, x in p.items()},
                   1e-3, 1, use_pallas=True)
    finally:
        cuda_adam.adam_tree = real
    assert calls == [[(5,), (3, 7)]]
    assert torch.equal(p["i"], torch.ones(2, dtype=torch.int32))
    assert not torch.equal(p["a"], torch.ones(5))


# a tree with odd sizes and mixed gradient dtypes, as the kernel's table
# takes it (one moment dtype a tree), and an int leaf the update skips
MIXED = {"one": ((1,), "bfloat16"), "seven": ((7,), "float32"),
         "k": ((1000,), "bfloat16"), "w": ((24, 40), "float32"),
         "h": ((3, 5, 7), "float16"), "i": ((4,), None)}


@pytest.mark.parametrize("mom_dtype", ["float32", "bfloat16"])
def test_adam_tree_plain_matches_jax_on_a_mixed_tree(mom_dtype):
    """``adam_tree_plain`` (through ``adam_apply(use_pallas=True)`` on
    the CPU, and called directly) against JAX's XLA-form ``adam_apply``
    from carried moments, with the moments' tolerances of
    ``test_adam_apply_matches_jax``; the int leaf untouched. Params
    within 1e-7 absolute or one float32 ulp of their value: PyTorch's
    CPU sqrt is not correctly rounded (it departs from numpy's and XLA's
    on about 0.7% of float32 inputs), which moves p by one ulp in about
    one element of 25,000 (4 of 100,000 unit-scale elements in a probe),
    and one ulp at |p| >= 1 exceeds 1e-7."""
    rng = np.random.default_rng(5)
    mdt = jnp.dtype(mom_dtype)

    def arr(shape, scale, dtype):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        return np.asarray(jnp.asarray(a).astype(dtype))

    p, m, v, g = {}, {}, {}, {}
    for k, (shape, gdt) in MIXED.items():
        if gdt is None:
            p[k] = m[k] = v[k] = g[k] = np.arange(4, dtype=np.int32)
            continue
        p[k] = arr(shape, 1.0, np.float32)
        m[k] = arr(shape, 0.1, mdt)
        v[k] = np.abs(arr(shape, 0.01, mdt))
        g[k] = arr(shape, 1.0, jnp.dtype(gdt))
    jp, jm, jv = j_adam_apply(*({k: jnp.asarray(a) for k, a in d.items()}
                                for d in (p, m, v, g)),
                              3e-3, jnp.int32(4), use_pallas=False)
    tp, tm, tv, tg = ({k: from_jax(a) for k, a in d.items()}
                      for d in (p, m, v, g))
    keys = [k for k in MIXED if MIXED[k][1] is not None]
    direct = [[d[k].clone() for k in keys] for d in (tp, tm, tv)]
    cuda_adam.reset_launches()
    adam_apply(tp, tm, tv, tg, 3e-3, 4, use_pallas=True)
    assert cuda_adam.LAUNCHES["adam"] == 0        # CPU: the plain version
    cuda_adam.adam_tree_plain(*direct, [tg[k] for k in keys],
                              adam_scalars(3e-3, 4), 0.9, 0.999, 1e-8)
    assert np.array_equal(to_jax(tp["i"]), p["i"])
    for j, k in enumerate(keys):
        for d, got in zip((tp, tm, tv), direct):
            assert torch.equal(d[k], got[j]), k
        np.testing.assert_allclose(to_jax(tp[k]), np.asarray(jp[k]),
                                   atol=1e-7, rtol=2 ** -23)
        for got, want in ((tm[k], jm[k]), (tv[k], jv[k])):
            assert got.dtype == getattr(torch, mom_dtype)
            got = to_jax(got).astype(np.float32)
            want = np.asarray(want).astype(np.float32)
            if mom_dtype == "float32":
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=0)


def _chunks(n, h, chunk):
    return max(1, -(-(n - max(h, 0)) // chunk))


@pytest.mark.parametrize("n_leaves", [1, 48, 100])
def test_leaf_table_partitions_the_leaves_into_launches(n_leaves):
    """At most MAX_LEAVES non-empty leaves a launch, in the tree's order,
    each leaf's first chunk the sum of the chunks before it in its launch
    (a chunk never spans two leaves), empty leaves left out."""
    rng = np.random.default_rng(n_leaves)
    ns = [int(x) for x in rng.integers(1, 3 * cuda_adam.CHUNK, n_leaves)]
    ns[n_leaves // 2] = 0                                # an empty leaf
    heads = [min(int(h), n) for h, n in
             zip(rng.integers(-1, 8, n_leaves), ns)]
    launches = cuda_adam._leaf_table(ns, heads)
    live = [i for i, n in enumerate(ns) if n]
    assert [i for idx, _, _ in launches for i in idx] == live
    assert len(launches) == -(-len(live) // cuda_adam.MAX_LEAVES)
    for idx, firsts, total in launches:
        assert 1 <= len(idx) <= cuda_adam.MAX_LEAVES
        sizes = [_chunks(ns[i], heads[i], cuda_adam.CHUNK) for i in idx]
        assert firsts == [sum(sizes[:j]) for j in range(len(idx))]
        assert total == sum(sizes)
    # by hand: a one-element leaf, an empty one, an exact chunk, a head
    # of 3 leaving 4094 for one chunk, and a scalar leaf of three chunks
    assert cuda_adam._leaf_table([1, 0, 4096, 4097, 8193],
                                 [0, 0, 0, 3, -1], chunk=4096) == [
        ([0, 2, 3, 4], [0, 1, 2, 3], 6)]
    assert cuda_adam._leaf_table([0, 0], [0, 0]) == []


def test_head_finds_the_common_alignment():
    """The scalar head before every pointer of a leaf is 16-byte aligned:
    0 for aligned pointers, 7 for views one element in (float32 p and
    moments, bf16 g: 4 + 28 and 2 + 14 bytes), -1 where no head of 0-7
    elements aligns them all."""
    f32, bf = 4, 2
    assert cuda_adam._head((256, 512, 768, 1024), (f32, f32, f32, bf)) == 0
    assert cuda_adam._head((260, 516, 772, 1026), (f32, f32, f32, bf)) == 7
    assert cuda_adam._head((260, 514, 770, 1026), (f32, bf, bf, bf)) == 7
    assert cuda_adam._head((264, 520, 520, 520), (f32, f32, f32, f32)) == 2
    assert cuda_adam._head((260, 512, 768, 1024), (f32, f32, f32, bf)) == -1
