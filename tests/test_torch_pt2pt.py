"""icikit_torch's point-to-point primitives against icikit.parallel.pt2pt.

The same seeded numpy blocks go through JAX's primitives inside
``shard_map`` on the simulated 8-device CPU mesh and through the port's
rank-vectorised ones on the (p, ...) operand; outputs are bitwise equal
and the validation errors are JAX's. Each primitive's exchanges go
through ``transport.ppermute``: a checked-mode tracker sees them.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from icikit.parallel import pt2pt as jpt
from icikit.parallel.shmap import shard_map
from icikit.utils.mesh import UnsupportedMeshError as JUnsupported
from icikit.utils.mesh import make_mesh as j_make_mesh
from icikit.utils.mesh import shard_along as j_shard
from icikit_torch.parallel import pt2pt, transport
from icikit_torch.utils.mesh import UnsupportedMeshError


def _data(p, n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(-10_000, 10_000, (p, n)).astype(np.int32)


def _jax(mesh, data, per_block, n_out=1):
    x = j_shard(jnp.asarray(data), mesh)
    spec = P("p")
    out = shard_map(lambda b: per_block(b[0]), mesh=mesh, in_specs=spec,
                    out_specs=spec if n_out == 1 else (spec,) * n_out)(x)
    return out


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.shape == want.shape and got.numpy().dtype == want.dtype
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("prim", ["shift", "xor", "send_to"])
def test_pt2pt_primitives(mesh8, prim):
    p = 8
    data = _data(p, 4, seed=3)
    x = torch.from_numpy(data)
    if prim == "shift":
        got = pt2pt.sendrecv_shift(x, p, 2)
        want = _jax(mesh8, data,
                    lambda b: jpt.sendrecv_shift(b, "p", p, 2)[None])
        np.testing.assert_array_equal(got.numpy(), np.roll(data, 2, axis=0))
    elif prim == "xor":
        got = pt2pt.sendrecv_xor(x, p, 3)
        want = _jax(mesh8, data,
                    lambda b: jpt.sendrecv_xor(b, "p", p, 3)[None])
        np.testing.assert_array_equal(got.numpy(), data[np.arange(p) ^ 3])
    else:
        # targeted send 0 -> 5: the receiver sees the payload, idle
        # ranks zeros
        got = pt2pt.send_to(x, [(0, 5)])
        want = _jax(mesh8, data, lambda b: jpt.send_to(b, "p", [(0, 5)])[None])
        np.testing.assert_array_equal(got[5].numpy(), data[0])
        assert (got.numpy()[np.arange(p) != 5] == 0).all()
    _same(got, want)


@pytest.mark.parametrize("p,mask", [(6, 2), (8, 0), (8, 8)])
def test_sendrecv_xor_validates(p, mask):
    data = _data(p, 4, seed=5)
    mesh = j_make_mesh(p)
    jerr = JUnsupported if p == 6 else ValueError
    with pytest.raises(jerr) as want:
        _jax(mesh, data, lambda b: jpt.sendrecv_xor(b, "p", p, mask)[None])
    terr = UnsupportedMeshError if p == 6 else ValueError
    with pytest.raises(terr) as got:
        pt2pt.sendrecv_xor(torch.from_numpy(data), p, mask)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_halo_exchange(mesh8, periodic, dtype):
    p, n, w = 8, 6, 2
    data = _data(p, n, seed=6).astype(dtype)
    lh, rh = pt2pt.halo_exchange(torch.from_numpy(data), p, w,
                                 periodic=periodic)
    jl, jr = _jax(mesh8, data, lambda b: tuple(
        h[None] for h in jpt.halo_exchange(b, "p", p, w, periodic)), 2)
    _same(lh, jl)
    _same(rh, jr)
    for d in range(p):
        want_l = data[(d - 1) % p, -w:]
        want_r = data[(d + 1) % p, :w]
        if not periodic and d == 0:
            want_l = np.zeros((w,), dtype)
        if not periodic and d == p - 1:
            want_r = np.zeros((w,), dtype)
        np.testing.assert_array_equal(lh[d].numpy(), want_l)
        np.testing.assert_array_equal(rh[d].numpy(), want_r)


@pytest.mark.parametrize("width", [0, 5])
def test_halo_width_validated(mesh8, width):
    data = _data(8, 4, seed=7)
    with pytest.raises(ValueError, match="halo width") as want:
        _jax(mesh8, data, lambda b: jpt.halo_exchange(b, "p", 8, width)[0][None])
    with pytest.raises(ValueError, match="halo width") as got:
        pt2pt.halo_exchange(torch.from_numpy(data), 8, width)
    assert str(got.value) == str(want.value)


def test_barrier_is_consumable(mesh8):
    data = _data(8, 4, seed=8)
    got = torch.from_numpy(data) + pt2pt.barrier(8, "cpu")[:, None]
    want = _jax(mesh8, data, lambda b: (b + jpt.barrier("p"))[None])
    _same(got, want)
    assert pt2pt.barrier(8, "cpu").dtype == torch.int32


def test_exchanges_go_through_the_transport():
    """A checked-mode tracker sees each primitive's exchanges (one a
    primitive, two for the halo), and the barrier, a reduction, none."""
    x = torch.from_numpy(_data(8, 4, seed=9))
    tracker = transport.Tracker("p", None)
    with transport.checked(tracker):
        pt2pt.send_to(x, [(0, 5)])
        pt2pt.sendrecv_shift(x, 8, 1)
        pt2pt.sendrecv_xor(x, 8, 4)
        pt2pt.halo_exchange(x, 8, 1)
        pt2pt.barrier(8, "cpu")
    assert tracker.calls == 5
    assert all(bool(ok.all()) for ok in tracker.oks)


def test_reexports_the_partner_permutations():
    from icikit_torch.parallel import shmap
    assert pt2pt.shift_perm is shmap.shift_perm
    assert pt2pt.xor_perm is shmap.xor_perm
    assert pt2pt.partial_shift_perm is shmap.partial_shift_perm
    assert pt2pt.xor_perm(4, 1) == ((0, 1), (1, 0), (2, 3), (3, 2))
