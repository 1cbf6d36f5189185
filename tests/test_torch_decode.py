"""The port's greedy decode against the JAX package's, on the CPU.

Both packages get the same weights (JAX's ``init_params``, carried over
by ``interop.params_from_jax``) and the same numpy prompt. At float32
the port's greedy tokens must equal JAX's **unfused** ``greedy_generate``
bitwise, with either of the port's decode-step arms: JAX's fused
generate cannot be the oracle on this image (its interpret-mode kernel
fails under shard_map's vma check on jax 0.9.0), while the unfused one
passes the re-forward oracle (``tests/test_decode.py``). At bf16 the
prefill's last-position logits agree within 0.05 absolute, three bf16
ulps at logits of 2 to 4 (an ulp is 2^-6 there): the two frameworks
round the bf16 activations at different places (XLA keeps float32
inside its fusions).
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
from jax.sharding import NamedSharding, PartitionSpec as P

from icikit.models.transformer import TransformerConfig as JConfig
from icikit.models.transformer import init_params as j_init_params
from icikit.models.transformer.decode import greedy_generate as j_generate
from icikit.models.transformer.model import make_model_mesh as j_mesh
from icikit_torch.interop import params_from_jax
from icikit_torch.models.transformer import (TransformerConfig,
                                             greedy_generate, init_params,
                                             make_model_mesh,
                                             sample_generate)
from icikit_torch.ops import cuda_attention

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_decode.py's CFG (d_head 8) and _fused_cfg (d_head 128)
CFG = dict(vocab=61, d_model=32, n_heads=4, d_head=8, d_ff=64, n_layers=2,
           max_seq=24, compute_dtype="float32")
FUSED = dict(vocab=61, d_model=64, n_heads=2, d_head=128, d_ff=96,
             n_layers=2, max_seq=24, compute_dtype="float32")


def _both(cfg: dict, seed: int = 0, batch: int = 2, s: int = 8):
    """JAX params and prompt, and the port's copies on the CPU."""
    mesh = j_mesh(dp=1, tp=1, sp=1)
    jparams = j_init_params(jax.random.key(seed), JConfig(**cfg), mesh)
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, cfg["vocab"], (batch, s)).astype(np.int32)
    tparams = params_from_jax({k: np.asarray(v) for k, v in jparams.items()},
                              "cpu")
    return mesh, jparams, prompt, tparams


def _jax_tokens(cfg: dict, mesh, jparams, prompt, n_new):
    pd = jax.device_put(jnp.asarray(prompt),
                        NamedSharding(mesh, P("dp", None)))
    return np.asarray(j_generate(jparams, pd, mesh,
                                 JConfig(**cfg, decode_step="unfused"),
                                 n_new=n_new))


@pytest.mark.parametrize("step", ["fused", "unfused"])
@pytest.mark.parametrize("pos_encoding", ["learned", "rope"])
def test_greedy_tokens_equal_jax_unfused(pos_encoding, step):
    cfg = dict(FUSED, pos_encoding=pos_encoding)
    mesh, jparams, prompt, tparams = _both(cfg)
    want = _jax_tokens(cfg, mesh, jparams, prompt, 6)
    cuda_attention.reset_launches()
    got = greedy_generate(tparams, torch.from_numpy(prompt),
                          make_model_mesh(device="cpu"),
                          TransformerConfig(**cfg, decode_step=step),
                          n_new=6)
    assert set(cuda_attention.LAUNCHES.values()) == {0}  # CPU: plain
    assert got.dtype == torch.int32 and got.shape == (2, 14)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("pos_encoding", ["learned", "rope"])
def test_greedy_tokens_equal_jax_narrow_heads(pos_encoding):
    """d_head 8 (test_decode.py's CFG): the unfused arm only."""
    cfg = dict(CFG, pos_encoding=pos_encoding)
    mesh, jparams, prompt, tparams = _both(cfg, seed=1, batch=4)
    want = _jax_tokens(cfg, mesh, jparams, prompt, 6)
    got = greedy_generate(tparams, torch.from_numpy(prompt),
                          make_model_mesh(device="cpu"),
                          TransformerConfig(**cfg), n_new=6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_tokens_equal_jax_gqa_dense_prefill():
    """GQA (2 K/V heads for 4 query heads) with the dense prefill."""
    cfg = dict(CFG, n_kv_heads=2, attention_impl="dense")
    mesh, jparams, prompt, tparams = _both(cfg, seed=2)
    want = _jax_tokens(cfg, mesh, jparams, prompt, 5)
    got = greedy_generate(tparams, torch.from_numpy(prompt),
                          make_model_mesh(device="cpu"),
                          TransformerConfig(**cfg), n_new=5)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fused_gate_rejects_loudly():
    cfg = TransformerConfig(**CFG, decode_step="fused")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="decode_step='fused'"):
        greedy_generate(params, torch.zeros((1, 4), dtype=torch.int32),
                        make_model_mesh(device="cpu"), cfg, n_new=2)


def _jax_prefill_logits(cfg: dict, mesh, jparams, prompt):
    from icikit.models.transformer.decode import _DecodeCtx, _prefill
    from icikit.models.transformer.model import param_specs
    from icikit.parallel.shmap import wrap_program

    jcfg = JConfig(**cfg)
    ctx = _DecodeCtx(jcfg, mesh)
    s = prompt.shape[1]

    def per_shard(params, prompt):
        x, _ = _prefill(ctx, params, prompt, s, s, False)
        return ctx.logits(params, x[:, -1])

    f = wrap_program(per_shard, mesh, (param_specs(jcfg), P("dp", None)),
                     P("dp", None))
    return np.asarray(f(jparams, jnp.asarray(prompt)))


@pytest.mark.parametrize("pos_encoding", ["learned", "rope"])
def test_bfloat16_prefill_logits_match_jax(pos_encoding):
    cfg = dict(FUSED, compute_dtype="bfloat16", pos_encoding=pos_encoding)
    mesh, jparams, prompt, tparams = _both(cfg, seed=3)
    want = _jax_prefill_logits(cfg, mesh, jparams, prompt)
    _, logits = greedy_generate(tparams, torch.from_numpy(prompt),
                                make_model_mesh(device="cpu"),
                                TransformerConfig(**cfg), n_new=1,
                                return_logits=True)
    assert logits.shape == (1, 2, cfg["vocab"])
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits[0].numpy(), want, atol=0.05, rtol=0)


def test_params_from_jax_keeps_names_shapes_dtypes():
    for cfg in (dict(FUSED), dict(CFG, pos_encoding="rope"),
                dict(CFG, n_kv_heads=2)):
        _, jparams, _, tparams = _both(cfg)
        assert set(tparams) == set(jparams)
        for k, v in jparams.items():
            assert tuple(tparams[k].shape) == v.shape
            assert tparams[k].dtype == torch.float32
            np.testing.assert_array_equal(tparams[k].numpy(), np.asarray(v))
        mine = init_params(TransformerConfig(**cfg),
                           torch.Generator().manual_seed(0), "cpu")
        assert {k: tuple(v.shape) for k, v in mine.items()} == {
            k: v.shape for k, v in jparams.items()}


def test_base_preset_sizes_match_jax():
    from icikit.bench.train import PRESETS as J_PRESETS
    from icikit.bench.train import matmul_param_count as j_count
    from icikit_torch.bench.train import PRESETS, matmul_param_count

    assert PRESETS == J_PRESETS
    for name, p in PRESETS.items():
        assert matmul_param_count(TransformerConfig(**p)) == j_count(
            JConfig(**p))
    assert matmul_param_count(TransformerConfig(**PRESETS["base"])) \
        == 218_103_808


def test_decode_byte_model_matches_jax_without_resident_share():
    from icikit.bench.decode import decode_bytes_per_token as j_bytes
    from icikit_torch.bench.decode import decode_bytes_per_token, make_config

    cfg = make_config("base", 512, 64)
    assert decode_bytes_per_token(cfg, 8, 576) == j_bytes(
        JConfig(**{f: getattr(cfg, f) for f in ("vocab", "d_model",
                                                "n_heads", "d_head", "d_ff",
                                                "n_layers", "max_seq")}),
        8, 576, vmem_resident=0)


def test_config_maps_every_jax_field():
    import dataclasses
    jf = {f.name: f.default for f in dataclasses.fields(JConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(TransformerConfig)}
    assert tf == jf


def test_unported_paths_refuse_loudly():
    mesh = make_model_mesh(device="cpu")
    gen = torch.Generator().manual_seed(0)
    for over, what in ((dict(n_experts=2), "n_experts"),
                       (dict(decode_quant="int8"), "B14"),
                       (dict(draft_head=True), "draft_head")):
        with pytest.raises(NotImplementedError, match=what):
            init_params(TransformerConfig(**CFG, **over), gen, "cpu")
    with pytest.raises(NotImplementedError, match="A5"):
        make_model_mesh(tp=2)
    with pytest.raises(NotImplementedError, match="sampled decode"):
        sample_generate()
    cfg = TransformerConfig(**CFG)
    params = init_params(cfg, gen, "cpu")
    with pytest.raises(ValueError, match="max_seq"):
        greedy_generate(params, torch.zeros((1, 20), dtype=torch.int32),
                        mesh, cfg, n_new=8)
    assert make_model_mesh().device == "cuda"


BENCH_KEYS = {"metric", "value", "unit", "per_token_ms", "read_gbps",
              "decode_step", "decode_step_resolved", "decode_quant",
              "bytes_dtype", "backend", "batch", "includes_prefill",
              "bytes_model", "vmem_resident_bytes", "protocol", "windows",
              "discarded", "suspect", "session_quality",
              "per_token_ms_spread", "device", "power_limit"}


def test_decode_bench_runs_on_cpu_with_jax_record_keys():
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-m", "icikit_torch.bench.decode",
                        "--device", "cpu", "--preset", "tiny128",
                        "--batch", "2", "--prompt", "8", "--new", "4",
                        "--decode-step", "fused"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert BENCH_KEYS <= set(rec)
    assert rec["metric"] == "decode_tiny128_dp1tp1_b2_p8_n4_greedy_fused"
    assert rec["decode_step_resolved"] == "fused"
    assert rec["device"] == "cpu" and rec["power_limit"] is None
    assert rec["value"] > 0 and rec["unit"] == "tokens/s"
