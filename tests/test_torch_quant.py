"""The port's int8 quantization and matvec against the JAX package's, on
the CPU.

The same numpy inputs, made from a seed, go through both packages.
``quantize_last`` (int8 and both fp8 formats), ``dequantize_last`` and
``quantize_decode_params`` are float32 arithmetic that both packages
round the same way, so they are held bit for bit. The int8 matvec's
plain version (what a CPU tensor runs) is held against JAX's Pallas
kernel in interpret mode, called directly as JAX's own tests call it,
and against ``quant_matvec_reference``: the largest difference within
1e-6 of the largest |reference| entry (float32 sums of K products in
other orders; the int8 products are exact).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icikit.models.transformer import TransformerConfig as JConfig
from icikit.models.transformer import init_params as j_init_params
from icikit.models.transformer import quant as jmq
from icikit.models.transformer.model import make_model_mesh as j_mesh
from icikit.ops import quant as jq
from icikit_torch.interop import from_jax, params_from_jax, to_jax
from icikit_torch.models.transformer import TransformerConfig
from icikit_torch.models.transformer import quant as tmq
from icikit_torch.ops import cuda_quant
from icikit_torch.ops import quant as tq

MATVEC_TOL = 1e-6   # of the largest |reference| entry


def _rows(seed, shape, kind):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 30, shape[:-1] + (1,))
         ).astype(np.float32)
    if kind == "zero":
        x[..., ::3, :] = 0.0                  # every third row all zero
    elif kind == "saturate":
        x[..., 0] = 1e4                        # one huge entry a row
        x[..., 1] = -1e4
    return x


@pytest.mark.parametrize("qdtype", ["int8", "fp8_e4m3", "fp8_e5m2"])
@pytest.mark.parametrize("kind", ["random", "zero", "saturate"])
def test_quantize_last_matches_jax_bitwise(qdtype, kind):
    x = _rows(len(kind) + len(qdtype), (6, 9, 128), kind)
    jqv, jsc = jq.quantize_last(jnp.asarray(x), qdtype)
    tqv, tsc = tq.quantize_last(from_jax(x), qdtype)
    assert tqv.dtype == tq.QDTYPES[qdtype][0] and tsc.dtype == torch.float32
    np.testing.assert_array_equal(to_jax(tsc), np.asarray(jsc))
    np.testing.assert_array_equal(
        tqv.view(torch.int8).numpy(),
        np.asarray(jqv).view(np.int8))
    np.testing.assert_array_equal(to_jax(tq.dequantize_last(tqv, tsc)),
                                  np.asarray(jq.dequantize_last(jqv, jsc)))
    if kind == "zero":
        assert not bool(tsc[:, ::3].any()) and not bool(
            tq.dequantize_last(tqv, tsc)[:, ::3].any())
    if kind == "saturate" and qdtype == "int8":
        assert int(tqv[..., 0].min()) == 127 and int(tqv[..., 1].max()) == -127


def test_quantize_last_rejects_unknown_dtype():
    with pytest.raises(ValueError, match="unknown quant dtype"):
        tq.quantize_last(torch.zeros(2, 128), "int4")


def _matvec_inputs(seed, rows, n, k):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, k)).astype(np.float32)
    w8 = rng.integers(-127, 128, (n, k)).astype(np.int8)
    sc = (rng.uniform(0.0, 1.0, (n,)) / 127).astype(np.float32)
    return x, w8, sc


@pytest.mark.parametrize("rows,n,k", [(8, 384, 128), (1, 512, 256),
                                      (16, 256, 512)])
def test_quant_matvec_plain_matches_jax_kernel_and_reference(rows, n, k):
    x, w8, sc = _matvec_inputs(rows + n, rows, n, k)
    want_k = np.asarray(jq.quant_matvec(jnp.asarray(x), jnp.asarray(w8),
                                        jnp.asarray(sc), interpret=True))
    want_r = np.asarray(jq.quant_matvec_reference(
        jnp.asarray(x), jnp.asarray(w8), jnp.asarray(sc)))
    cuda_quant.reset_launches()
    got = tq.quant_matvec(from_jax(x), from_jax(w8), from_jax(sc))
    assert cuda_quant.LAUNCHES["quant_matvec"] == 0      # CPU: plain
    assert got.dtype == torch.float32 and got.shape == (rows, n)
    ref = tq.quant_matvec_reference(from_jax(x), from_jax(w8), from_jax(sc))
    for want in (want_k, want_r):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=MATVEC_TOL * np.abs(want).max())
        np.testing.assert_allclose(ref.numpy(), want, rtol=0,
                                   atol=MATVEC_TOL * np.abs(want).max())


@pytest.mark.parametrize("rows,n,k", [(8, 384, 128), (4, 4096, 1024),
                                      (2, 200, 128), (2, 384, 120),
                                      (2, 384, 0), (2, 100, 256)])
def test_quant_matvec_gate_matches_jax_and_refuses(rows, n, k):
    ok = jq.quant_matvec_supported(rows, n, k)
    assert tq.quant_matvec_supported(rows, n, k, "cpu") == ok
    assert tq.quant_matvec_supported(rows, n, k, "cuda") == ok
    assert not tq.quant_matvec_supported(rows, n, k, "meta")
    if not ok:
        with pytest.raises(ValueError, match="gate with"):
            tq.quant_matvec(torch.zeros(rows, k), torch.zeros(
                n, k, dtype=torch.int8), torch.zeros(n))


@pytest.mark.parametrize("impl", ["auto", "pallas", "xla"])
@pytest.mark.parametrize("k_ndim", [1, 2])
def test_qmm_impls_match_jax(impl, k_ndim):
    rng = np.random.default_rng(7 + k_ndim)
    x = rng.standard_normal((2, 3, 4, 64)).astype(np.float32)
    if k_ndim == 1:
        x = x.reshape(2, 3, 256)
        w = rng.standard_normal((5, 128, 256)).astype(np.float32)
    else:
        w = rng.standard_normal((384, 4, 64)).astype(np.float32)
    w8, sc = jq.quantize_last(jnp.asarray(w).reshape(
        w.shape[:w.ndim - k_ndim] + (-1,)))
    w8 = w8.reshape(w.shape)
    want = np.asarray(jq.qmm(jnp.asarray(x), w8, sc, k_ndim=k_ndim,
                             impl="xla"))
    cuda_quant.reset_launches()
    got = tq.qmm(from_jax(x), from_jax(np.asarray(w8)),
                 from_jax(np.asarray(sc)), k_ndim=k_ndim, impl=impl)
    assert cuda_quant.LAUNCHES["quant_matvec"] == 0
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=MATVEC_TOL * np.abs(want).max())


def test_qmm_refusals():
    x = torch.zeros(2, 200)
    w8 = torch.zeros(128, 200, dtype=torch.int8)
    with pytest.raises(ValueError, match="unknown quant impl"):
        tq.qmm(x, w8, torch.zeros(128), impl="triton")
    with pytest.raises(ValueError, match="contraction mismatch"):
        tq.qmm(x, w8[:, :100], torch.zeros(128))
    with pytest.raises(ValueError, match="gate with"):
        tq.qmm(x, w8, torch.zeros(128), impl="pallas")
    assert tq.qmm(x, w8, torch.zeros(128), impl="auto").shape == (2, 128)


CFG = dict(vocab=61, d_model=32, n_heads=4, d_head=8, d_ff=64, n_layers=2,
           max_seq=24, compute_dtype="float32")


@pytest.mark.parametrize("kv_heads", [0, 2])
@pytest.mark.parametrize("pos_encoding", ["learned", "rope"])
def test_quantize_decode_params_matches_jax_bitwise(kv_heads, pos_encoding):
    cfg = dict(CFG, n_kv_heads=kv_heads, pos_encoding=pos_encoding,
               decode_quant="int8")
    jcfg, tcfg = JConfig(**cfg), TransformerConfig(**cfg)
    jparams = j_init_params(jax.random.key(kv_heads),
                            JConfig(**dict(cfg, decode_quant="none")),
                            j_mesh(dp=1, tp=1, sp=1))
    want = jmq.quantize_decode_params(jparams, jcfg)
    tparams = params_from_jax({k: np.asarray(v) for k, v in jparams.items()},
                              "cpu")
    got = tmq.quantize_decode_params(tparams, tcfg, mesh="ignored")
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert tuple(got[k].shape) == w.shape, k
        assert got[k].is_contiguous(), k
        assert to_jax(got[k]).dtype == w.dtype, k
        np.testing.assert_array_equal(to_jax(got[k]), w, err_msg=k)
    assert tmq.quant_weight_keys(tcfg) == jmq.quant_weight_keys(jcfg)
    assert tmq.quant_layer_keys(tcfg) == jmq.quant_layer_keys(jcfg)
    assert tmq.SCALE_SUFFIX == jmq.SCALE_SUFFIX
    assert tmq._LAYOUTS == jmq._LAYOUTS
    assert tmq.is_quantized_params(got) and not tmq.is_quantized_params(
        tparams)
    assert tmq.quantize_decode_params(got, tcfg) is got
    with pytest.raises(ValueError, match="decode_quant='int8'"):
        tmq.quantize_decode_params(tparams, TransformerConfig(**CFG))
