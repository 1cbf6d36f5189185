"""The port's sequence-parallel schedules (``icikit_torch.models.attention``:
ring, zigzag, ulysses) against the JAX package's, on the CPU.

The same seeded numpy q, k, v go through the port's schedule on a CPU
``RankMesh`` of p ranks and through JAX's dense oracle (as JAX's own
``test_zigzag.py`` and ``test_model_schedules.py`` hold its schedules),
outputs and the gradients of ``sum(out^2)``, at p 1, 2, 4 and 8, causal
and not, and with GQA K/V; and at p = 4 against JAX's own schedule on
its simulated 8-device mesh. The port's flash calls run the kernels'
plain versions here. Tolerances: JAX's, 2e-5 on outputs, 5e-4 relative
and 5e-5 absolute on gradients.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icikit.models.attention import dense_attention as j_dense
from icikit.models.attention import ring_attention as j_ring
from icikit.models.attention import ulysses_attention as j_ulysses
from icikit.models.attention import zigzag_attention as j_zigzag
from icikit.utils.mesh import make_mesh as j_make_mesh
from icikit.utils.mesh import shard_along as j_shard
from icikit_torch.models.attention import (ring_attention,
                                           ulysses_attention,
                                           zigzag_attention)
from icikit_torch.models.attention.zigzag import _from_zigzag, _to_zigzag
from icikit_torch.utils.mesh import make_mesh

IMPLS = {"ring": ring_attention, "zigzag": zigzag_attention,
         "ulysses": ulysses_attention}
J_IMPLS = {"ring": j_ring, "zigzag": j_zigzag, "ulysses": j_ulysses}
B, S, H, D = 2, 32, 8, 8


def _qkv(h_kv=H, seed=0, s=S, h=H):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, s, h, D)).astype(np.float32),
            rng.standard_normal((B, s, h_kv, D)).astype(np.float32),
            rng.standard_normal((B, s, h_kv, D)).astype(np.float32))


def _port(impl, p, causal, q, k, v, **kw):
    """The port's output and the gradients of sum(out^2)."""
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = IMPLS[impl](*ts, make_mesh(p, device="cpu"), causal=causal, **kw)
    (out ** 2).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


@functools.lru_cache(maxsize=None)
def _jax_dense_fn(causal: bool, n_rep: int):
    def f(q, k, v):
        out = j_dense(q, jnp.repeat(k, n_rep, axis=2),
                      jnp.repeat(v, n_rep, axis=2), causal=causal)
        return jnp.sum(out ** 2), out

    return jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True))


def _jax_dense(causal, q, k, v):
    """JAX's dense oracle (GQA K/V repeated to the query heads) and its
    gradients, summed back over each K/V head's group."""
    (_, out), grads = _jax_dense_fn(causal, q.shape[2] // k.shape[2])(
        q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _close(got, want):
    out, grads = got
    np.testing.assert_allclose(out, want[0], rtol=2e-5, atol=2e-5)
    for g, w in zip(grads, want[1]):
        np.testing.assert_allclose(g, w, rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("p", [1, 2, 4, 8])
@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_schedule_matches_dense(impl, p, causal):
    q, k, v = _qkv(seed=p)
    _close(_port(impl, p, causal, q, k, v), _jax_dense(causal, q, k, v))


@pytest.mark.parametrize("h_kv", [1, 2, 4])
@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_schedule_gqa_matches_dense(impl, p, h_kv):
    """GQA: ring and zigzag rotate the un-repeated blocks; ulysses takes
    each of JAX's three K/V layouts (h_kv a multiple of p, p a multiple
    of h_kv, neither)."""
    q, k, v = _qkv(h_kv=h_kv, seed=10 + p)
    _close(_port(impl, p, True, q, k, v), _jax_dense(True, q, k, v))


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_schedule_matches_jax_schedule(impl):
    """At p = 4, causal, GQA 2: the port against JAX's own schedule on
    its simulated mesh, outputs and gradients."""
    q, k, v = _qkv(h_kv=4, seed=3)
    mesh = j_make_mesh(4)

    def f(q, k, v):
        out = J_IMPLS[impl](q, k, v, mesh, causal=True)
        return jnp.sum(out ** 2), out

    args = [j_shard(jnp.asarray(x), mesh, dim=1) for x in (q, k, v)]
    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                         has_aux=True)(*args)
    _close(_port(impl, 4, True, q, k, v),
           (np.asarray(out), [np.asarray(g) for g in grads]))


@pytest.mark.parametrize("algorithm", ["naive", "ecube", "hypercube",
                                       "wraparound", "xla"])
def test_ulysses_alltoall_variants(algorithm):
    """Every alltoall variant carries the re-shard (JAX's sp_algorithm),
    outputs and gradients equal to the dense oracle."""
    q, k, v = _qkv(seed=7)
    _close(_port("ulysses", 4, True, q, k, v, algorithm=algorithm),
           _jax_dense(True, q, k, v))


def test_zigzag_layout_roundtrip():
    """_to_zigzag/_from_zigzag are inverse, and rank r holds chunks (r,
    2p-1-r), as JAX's helpers lay them out."""
    p = 8
    x = torch.arange(2 * 32, dtype=torch.int32).view(2, 32)
    blocks = x.view(2, p, 4).movedim(1, 0)          # (p, n, s)
    zz = _to_zigzag(blocks, p)
    assert torch.equal(_from_zigzag(zz, p), blocks)
    chunks = x.view(2, 2 * p, 2)
    for r in range(p):
        want = torch.cat([chunks[:, r], chunks[:, 2 * p - 1 - r]], dim=1)
        assert torch.equal(zz[r], want)


def test_zigzag_non_pow2_mesh():
    q, k, v = _qkv(s=36, seed=2)
    _close(_port("zigzag", 6, True, q, k, v), _jax_dense(True, q, k, v))


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_schedule_validation_matches_jax(impl):
    """The shape errors name what JAX's name."""
    q, k, v = _qkv(s=24)          # 24 divides by p = 8 but not 2p
    cases = [("zigzag", (q, k, v), True, "zigzag chunks"),
             ("ring", _qkv(s=20), False, "sequence length"),
             ("ulysses", _qkv(h=4, h_kv=4), False, "head count")]
    for name, args, causal, msg in cases:
        if name != impl:
            continue
        ts = [torch.from_numpy(a) for a in args]
        with pytest.raises(ValueError, match=msg):
            IMPLS[impl](*ts, make_mesh(8, device="cpu"), causal=causal)
        with pytest.raises(ValueError, match=msg):
            J_IMPLS[impl](*[jnp.asarray(a) for a in args], j_make_mesh(8),
                          causal=causal)
    # GQA heads must divide the query heads
    q, k, v = _qkv(h_kv=3)
    with pytest.raises(ValueError, match="multiple of K/V heads"):
        _port(impl, 4, True, q, k, v)
