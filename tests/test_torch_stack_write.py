"""The save stack (B16) against the JAX package's, on the CPU.

``stack_write``/``stack_read`` against JAX's (its Pallas kernels in
interpret mode) on the shapes of JAX's ``tests/test_stack_write.py``, bit
for bit: a slice copy has one answer. ``stack_supported`` against JAX's
gate over a grid of slice shapes and dtypes, so the port routes a slice
to its kernel exactly where JAX routes it to Pallas. ``remat_scan_stacked``
against JAX's on JAX's synthetic layer: the value within rtol 1e-6, both
gradient trees within 1e-5 (float32 sums in other orders through three
layers). The model's float32 loss and every gradient leaf with
``save_stack="pallas"`` against JAX's ``save_stack="xla"`` on parameters
carried by ``params_from_jax``: the loss within 1e-5 relative, each leaf
within 1e-4 relative L2. JAX's own Pallas save-stack model path fails on
jax 0.9.0 in interpret mode (shard_map's vma check), so its
``save_stack="xla"``, the same function, is the oracle. At d_model 128
the residual and matrix slices pass the gate and the norm slices (one
128-lane float32 row, under the sublane rule) take the plain route, so
both routes run.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icikit.models.transformer import TransformerConfig as JConfig
from icikit.models.transformer import init_params as j_init_params
from icikit.models.transformer.model import loss_and_metrics as j_loss
from icikit.models.transformer.model import make_model_mesh as j_mesh
from icikit.ops import stack_write as jsw
from icikit_torch.interop import from_jax, params_from_jax, to_jax
from icikit_torch.models.transformer import (FusedAdam, TransformerConfig,
                                             loss_and_metrics,
                                             make_model_mesh,
                                             make_train_step)
from icikit_torch.ops import cuda_stack
from icikit_torch.ops import stack_write as tsw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


# ------------------------------------------------------------- kernels

# (stack shape, dtype, slice index), JAX's test cases: the roundtrip, bf16
# with a (b, s, d) slice, and the unsupported slice that falls back
CASES = [((4, 16, 128), "float32", 0), ((4, 16, 128), "float32", 2),
         ((4, 16, 128), "float32", 3), ((2, 2, 8, 128), "bfloat16", 1),
         ((3, 5), "float32", 2)]


@pytest.mark.parametrize("shape,dtype,i", CASES)
def test_write_and_read_match_jax_bitwise(shape, dtype, i):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(11 + i)
    stack = jnp.asarray(rng.standard_normal(shape), jdt)
    x = jnp.asarray(rng.standard_normal(shape[1:]), jnp.float32)
    want = jsw.stack_write(stack, x, i, interpret=True)
    want_read = jsw.stack_read(want, i, interpret=True)
    tstack, tx = from_jax(np.asarray(stack)), from_jax(np.asarray(x))
    cuda_stack.reset_launches()
    got = tsw.stack_write(tstack, tx, i)          # x cast to the stack's
    assert got is tstack                          # in place
    assert np.array_equal(to_jax(got).view(np.uint8),
                          np.asarray(want).view(np.uint8))
    read = tsw.stack_read(got, i)
    assert read.dtype == tdt and read.shape == tuple(shape[1:])
    assert np.array_equal(to_jax(read).view(np.uint8),
                          np.asarray(want_read).view(np.uint8))
    assert set(cuda_stack.LAUNCHES.values()) == {0}   # CPU: plain copies
    assert tsw.stack_supported(shape[1:], tdt) == jsw.stack_supported(
        shape[1:], jdt)


SLICES = [(), (5,), (8,), (128,), (1024,), (8, 128), (9, 128), (16, 128),
          (24, 128), (2, 8, 128), (3, 128), (4, 32), (33, 128),
          (1024, 128), (2048, 128), (1024, 3, 8, 128), (8, 1024, 1024),
          (1536, 128), (384, 128)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("slice_shape", SLICES, ids=str)
def test_gate_matches_jax(slice_shape, dtype):
    jdt, tdt = DTYPES[dtype]
    assert tsw.stack_supported(slice_shape, tdt) == jsw.stack_supported(
        slice_shape, jdt)
    size = int(np.prod(slice_shape)) if slice_shape else 1
    assert tsw._row_tiles(size, tdt) == jsw._row_tiles(size, jdt)


def test_index_is_checked():
    stack = torch.zeros((3, 8, 128))
    for bad in (3, -1):
        with pytest.raises(ValueError, match="stack index"):
            tsw.stack_write(stack, torch.ones((8, 128)), bad)
        with pytest.raises(ValueError, match="stack index"):
            tsw.stack_read(stack, bad)


@pytest.mark.parametrize("slice_shape,dtype,x_dtype",
                         [((16, 128), torch.float32, torch.float32),
                          ((2, 8, 128), torch.bfloat16, torch.float32),
                          ((1024,), torch.float32, torch.bfloat16),
                          ((9, 128), torch.bfloat16, torch.bfloat16)],
                         ids=str)
def test_checked_once_copier_equals_the_plain_copies(slice_shape, dtype,
                                                     x_dtype):
    """The layer loop's copiers (a stack checked once, then writes and
    reads by index) equal the plain copies bit for bit on the CPU, on
    the gate and off it ((9, 128) bf16), with x cast to the stack's
    dtype; they launch nothing here and check their index."""
    rng = np.random.default_rng(3)
    stack = torch.from_numpy(rng.standard_normal((4,) + slice_shape)
                             .astype(np.float32)).to(dtype)
    want = stack.clone()
    write, read = tsw._copier("pallas", stack)
    cuda_stack.reset_launches()
    for i in (3, 0, 2):
        x = torch.from_numpy(rng.standard_normal(slice_shape)
                             .astype(np.float32)).to(x_dtype)
        write(x, i)
        cuda_stack.stack_write_plain(want, x, i)
        assert torch.equal(stack.view(torch.uint8), want.view(torch.uint8))
        got = read(i)
        assert got.dtype == dtype and got.shape == slice_shape
        assert torch.equal(got.view(torch.uint8),
                           cuda_stack.stack_read_plain(want, i)
                           .view(torch.uint8))
    assert set(cuda_stack.LAUNCHES.values()) == {0}
    if tsw.stack_supported(slice_shape, dtype):
        for bad in (4, -1):
            with pytest.raises(ValueError, match="stack index"):
                write(x, bad)
            with pytest.raises(ValueError, match="stack index"):
                read(bad)


# ------------------------------------------- explicit-stack layer scan


def _synthetic(L, D, rows, seed):
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((rows, D)).astype(np.float32)
    lps = {"w": (rng.standard_normal((L, D, D)) / np.sqrt(D)
                 ).astype(np.float32),
           "b": rng.standard_normal((L, D)).astype(np.float32)}
    return x0, lps


def _j_layer(x, lp, positions):
    y = jnp.tanh(x @ lp["w"] + lp["b"])
    return x + y, jnp.sum(y * y).astype(jnp.float32)


def _t_layer(x, lp, positions):
    y = torch.tanh(x @ lp["w"] + lp["b"])
    return x + y, (y * y).sum().float()


def _port_value_and_grads(x0, lps, impl, layer=_t_layer, aux_coef=0.1):
    x0 = torch.from_numpy(x0).requires_grad_(True)
    lps = {k: torch.from_numpy(v).requires_grad_(True)
           for k, v in lps.items()}
    positions = torch.arange(x0.shape[0], dtype=torch.int32)
    x, aux = tsw.remat_scan_stacked(layer, x0, lps, positions, impl=impl)
    loss = (x * x).sum() + aux_coef * aux
    grads = torch.autograd.grad(loss, [x0, *lps.values()])
    return float(loss.detach()), [g.numpy() for g in grads]


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_remat_scan_stacked_matches_jax(impl):
    """JAX's synthetic layer (matmul, tanh, aux): the port's stacked scan
    against JAX's, value and the gradients of x0 and both stacks."""
    x0, lps = _synthetic(3, 64, 4, seed=1)
    positions = jnp.arange(4, dtype=jnp.int32)

    def loss(x0, lps):
        x, aux = jsw.remat_scan_stacked(_j_layer, x0, lps, positions,
                                        impl=impl, interpret=True)
        return jnp.sum(x * x) + 0.1 * aux

    v_j, (gx_j, gl_j) = jax.value_and_grad(loss, argnums=(0, 1))(
        jnp.asarray(x0), {k: jnp.asarray(v) for k, v in lps.items()})
    v_t, g_t = _port_value_and_grads(x0, lps, impl)
    np.testing.assert_allclose(v_t, float(v_j), rtol=1e-6)
    for got, want in zip(g_t, [gx_j, gl_j["w"], gl_j["b"]]):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_remat_scan_stacked_impls_agree_and_unused_leaves_get_zeros():
    """impl="xla" (the plain copies) gives the same values and gradients
    as "pallas"; a leaf the layer does not use gets a zero gradient, as
    JAX's zero-initialised gradient stacks give; an unknown impl raises
    with JAX's message."""
    x0, lps = _synthetic(2, 32, 2, seed=2)
    lps["unused"] = np.ones((2, 8, 128), np.float32)

    def layer(x, lp, positions):
        return torch.tanh(x @ lp["w"]), torch.zeros(())

    vp, gp = _port_value_and_grads(x0, lps, "pallas", layer)
    vx, gx = _port_value_and_grads(x0, lps, "xla", layer)
    assert vp == vx
    for a, b in zip(gp, gx):
        np.testing.assert_array_equal(a, b)
    assert not gp[-1].any() and gp[-1].shape == (2, 8, 128)
    with pytest.raises(ValueError, match="save-stack impl"):
        tsw.remat_scan_stacked(layer, torch.from_numpy(x0),
                               {"w": torch.from_numpy(lps["w"])},
                               torch.arange(2), impl="mosaic")


# ------------------------------------------------- the model's loss


CFG = dict(vocab=256, d_model=128, n_heads=4, d_head=32, d_ff=256,
           n_layers=3, max_seq=32, compute_dtype="float32",
           remat_policy="except_attn")


def _both(cfg, seed):
    mesh = j_mesh(dp=1, tp=1, sp=1)
    jparams = j_init_params(jax.random.key(seed), JConfig(**cfg), mesh)
    rng = np.random.default_rng(seed)
    tok, tgt = (rng.integers(0, cfg["vocab"], (2, cfg["max_seq"])
                             ).astype(np.int32) for _ in range(2))
    tparams = params_from_jax({k: np.asarray(v) for k, v in jparams.items()},
                              "cpu")
    return mesh, jparams, tok, tgt, tparams


@pytest.mark.parametrize("pos_encoding,kv_heads,shift",
                         [("learned", 0, 16.0), ("rope", 2, None)])
def test_model_save_stack_pallas_matches_jax_xla(pos_encoding, kv_heads,
                                                 shift):
    cfg = dict(CFG, pos_encoding=pos_encoding, n_kv_heads=kv_heads,
               softmax_shift=shift)
    mesh, jparams, tok, tgt, tparams = _both(cfg, seed=21 + kv_heads)
    jl, jg, _ = j_loss(jparams, jnp.asarray(tok), jnp.asarray(tgt), mesh,
                       JConfig(**cfg))
    assert not tsw.stack_supported(tparams["ln1"].shape[1:], torch.float32)
    assert tsw.stack_supported((2, 32, 128), torch.float32)   # residual
    loss, grads, _ = loss_and_metrics(
        tparams, torch.from_numpy(tok), torch.from_numpy(tgt),
        make_model_mesh(device="cpu"),
        TransformerConfig(**cfg, save_stack="pallas"))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert set(grads) == set(jg)
    for k, want in jg.items():
        want = np.asarray(want, np.float64)
        got = grads[k].double().numpy()
        assert got.shape == want.shape, k
        assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want), k


def test_save_stack_step_runs_and_bench_tags_it():
    """Three FusedAdam steps with the save stack on the CPU: the loss
    falls and equals the default arm's steps; the train bench runs it
    with JAX's ``_stack-pallas`` tag."""
    cfg = dict(CFG, pos_encoding="rope")
    _, _, tok, tgt, tparams = _both(cfg, seed=5)
    losses = {}
    for stack in ("xla", "pallas"):
        p = {k: v.clone() for k, v in tparams.items()}
        opt, step = make_train_step(make_model_mesh(device="cpu"),
                                    TransformerConfig(**cfg,
                                                      save_stack=stack),
                                    FusedAdam(1e-2))
        st = opt.init(p)
        losses[stack] = [float(step(p, st, torch.from_numpy(tok),
                                    torch.from_numpy(tgt))[2])
                         for _ in range(3)]
    np.testing.assert_allclose(losses["pallas"], losses["xla"], rtol=1e-5)
    assert losses["pallas"][2] < losses["pallas"][0]
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-m", "icikit_torch.bench.train",
                        "--device", "cpu", "--preset", "tiny", "--batch",
                        "2", "--steps", "1", "--warmup", "1", "--windows",
                        "1", "--save-stack", "pallas"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert rec["metric"].endswith("_stack-pallas")
    assert rec["save_stack"] == "pallas" and np.isfinite(rec["loss"])
