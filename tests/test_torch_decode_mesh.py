"""The port's generate on the model mesh against the JAX package's, on
the CPU.

Both packages get the same weights (JAX's ``init_params`` on the mesh
under test, carried over whole by ``interop.params_from_jax``) and the
same numpy prompt. At float32 the port's greedy tokens at a (dp, tp)
mesh must equal JAX's unfused ``greedy_generate`` at that mesh bit for
bit (the protocol of JAX's ``test_greedy_decode_matches_reforward_
oracle``), with and without ``vocab_parallel`` (JAX's
``test_decode_matches_replicated``), and in int8 the XLA form of JAX's
int8 generate (``quant_matvec="xla"``, JAX's
``test_int8_generate_mesh_invariance``): JAX's fused and Pallas int8
generates are no oracle on this image (``tests/test_torch_decode.py``).
The port's fused step (its plain version here) is held to its unfused
tokens at tp 2.
"""

from __future__ import annotations

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
from icikit.models.transformer.quant import (
    decode_param_specs as j_decode_specs,
)
from icikit.models.transformer.quant import (
    quant_param_specs as j_quant_specs,
)
from icikit_torch import chaos
from icikit_torch.interop import params_from_jax
from icikit_torch.models.transformer import (TransformerConfig,
                                             greedy_generate, init_params,
                                             make_model_mesh)
from icikit_torch.models.transformer import model as tmodel
from icikit_torch.models.transformer import quant as tquant
from icikit_torch.models.transformer.decode import (_DecodeCtx, _prefill,
                                                    maybe_quantize_params)
from icikit_torch.ops import cuda_attention, cuda_quant

# tests/test_decode.py's CFG (d_head 8), and a fused-step width
CFG = dict(vocab=64, d_model=32, n_heads=4, d_head=8, d_ff=64, n_layers=2,
           max_seq=32, compute_dtype="float32")
FUSED = dict(vocab=64, d_model=64, n_heads=4, d_head=128, d_ff=96,
             n_layers=2, max_seq=24, compute_dtype="float32")
MESHES = [(2, 1), (1, 2), (2, 2), (1, 4)]


def _setup(cfg: dict, dp: int, tp: int, seed: int = 0, batch: int = 4,
           s: int = 8):
    """JAX's mesh, params and sharded prompt; the port's params and
    prompt on the CPU."""
    mesh = j_mesh(dp=dp, tp=tp, sp=1)
    init_cfg = JConfig(**dict(cfg, decode_quant="none"))
    jparams = j_init_params(jax.random.key(seed), init_cfg, mesh)
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, cfg["vocab"], (batch, s)).astype(np.int32)
    pd = jax.device_put(jnp.asarray(prompt),
                        NamedSharding(mesh, P("dp", None)))
    tparams = params_from_jax({k: np.asarray(v) for k, v in jparams.items()},
                              "cpu")
    return mesh, jparams, pd, tparams, torch.from_numpy(prompt)


def _port(tparams, prompt, dp, tp, cfg: dict, n_new, **kw):
    return greedy_generate(tparams, prompt,
                           make_model_mesh(dp=dp, tp=tp, device="cpu"),
                           TransformerConfig(**cfg), n_new, **kw)


@pytest.mark.parametrize("vocab_parallel", [False, True],
                         ids=["replicated", "vocab_parallel"])
@pytest.mark.parametrize("dp,tp", MESHES)
def test_greedy_tokens_equal_jax_on_the_mesh(dp, tp, vocab_parallel):
    cfg = dict(CFG, vocab_parallel=vocab_parallel, pos_encoding="rope")
    mesh, jparams, pd, tparams, prompt = _setup(cfg, dp, tp, seed=dp + tp)
    want = np.asarray(j_generate(jparams, pd, mesh,
                                 JConfig(**cfg, decode_step="unfused"), 6))
    got, logits = _port(tparams, prompt, dp, tp, cfg, 6, return_logits=True)
    assert got.dtype == torch.int32 and got.shape == (4, 14)
    np.testing.assert_array_equal(got.numpy(), want)
    # return_logits: full-width float32 rows the tokens were chosen from
    assert logits.shape == (6, 4, cfg["vocab"])
    assert logits.dtype == torch.float32
    np.testing.assert_array_equal(logits.argmax(-1).T.numpy(), want[:, 8:])


def test_vocab_parallel_decode_matches_replicated():
    """JAX's ``test_decode_matches_replicated``: the vocab-parallel head
    at (1, 4) gives the replicated head's (1, 1) tokens."""
    cfg = dict(CFG, vocab_parallel=True)
    _, _, _, tparams, prompt = _setup(cfg, 1, 4, seed=1)
    got = _port(tparams, prompt, 1, 4, cfg, 4)
    want = _port(tparams, prompt, 1, 1, dict(cfg, vocab_parallel=False), 4)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_gqa_tokens_equal_jax_at_tp2():
    cfg = dict(CFG, n_kv_heads=2, pos_encoding="rope")
    mesh, jparams, pd, tparams, prompt = _setup(cfg, 1, 2, seed=5)
    want = np.asarray(j_generate(jparams, pd, mesh,
                                 JConfig(**cfg, decode_step="unfused"), 6))
    np.testing.assert_array_equal(
        _port(tparams, prompt, 1, 2, cfg, 6).numpy(), want)


@pytest.mark.parametrize("dp,tp", [(1, 1), (2, 4)])
def test_int8_tokens_equal_jax_xla_form_on_the_mesh(dp, tp):
    cfg = dict(CFG, decode_quant="int8", vocab_parallel=tp > 1)
    mesh, jparams, pd, tparams, prompt = _setup(cfg, dp, tp, seed=1)
    want = np.asarray(j_generate(
        jparams, pd, mesh, JConfig(**cfg, quant_matvec="xla",
                                   decode_step="unfused"), 8))
    for impl in ("auto", "xla"):
        got = _port(tparams, prompt, dp, tp, dict(cfg, quant_matvec=impl), 8)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_fused_step_tokens_equal_unfused_at_tp2(quant):
    """The fused steps (B13's and B14's plain versions here) on the mesh:
    every rank's heads are rows of one launch a layer."""
    cfg = dict(FUSED, pos_encoding="rope", decode_quant=quant)
    _, _, _, tparams, prompt = _setup(cfg, 2, 2, seed=7)
    cuda_attention.reset_launches()
    cuda_quant.reset_launches()
    outs = {step: _port(tparams, prompt, 2, 2,
                        dict(cfg, decode_step=step), 8).numpy()
            for step in ("fused", "unfused")}
    assert set(cuda_attention.LAUNCHES.values()) == {0}   # CPU: plain
    assert cuda_quant.LAUNCHES["quant_matvec"] == 0
    np.testing.assert_array_equal(outs["fused"], outs["unfused"])
    np.testing.assert_array_equal(
        outs["fused"], _port(tparams, prompt, 1, 1, cfg, 8).numpy())


def test_fused_caches_hold_every_ranks_heads_as_rows():
    """At (2, 2) the fused layout is (tp b h_loc, total, dh): the rows
    of one launch, the batch's rows once a tp rank."""
    cfg = TransformerConfig(**FUSED, decode_quant="int8")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    mesh = make_model_mesh(dp=2, tp=2, device="cpu")
    ctx = _DecodeCtx(cfg, maybe_quantize_params(params, mesh, cfg), mesh)
    assert tuple(ctx.layers[0]["wqkv"].shape) == (2, 3, 2, 128, 64)
    assert tuple(ctx.layers[0]["wo_s"].shape) == (2, 64)
    b, s, total = 4, 8, 12
    prompt = torch.randint(0, cfg.vocab, (b, s), dtype=torch.int32)
    x, (kcs, _, kss, _) = _prefill(ctx, prompt, s, total, True)
    assert tuple(x.shape) == (2 * b, s, cfg.d_model)
    assert tuple(kcs[0].shape) == (b * cfg.n_heads, total, cfg.d_head)
    assert kcs[0].dtype == torch.int8
    assert tuple(kss[0].shape) == (b * cfg.n_heads, total)


def _tp_dim(spec):
    return next((i for i, a in enumerate(spec) if a == "tp"), None)


@pytest.mark.parametrize("over", [dict(), dict(vocab_parallel=True),
                                  dict(n_kv_heads=2),
                                  dict(pos_encoding="learned",
                                       vocab_parallel=True)],
                         ids=["mha", "vp", "gqa", "learned_vp"])
def test_quant_and_decode_param_specs_match_jax(over):
    cfg = dict(CFG, decode_quant="int8", **over)
    want = {k: _tp_dim(v) for k, v in j_quant_specs(JConfig(**cfg)).items()}
    assert tquant.quant_param_specs(TransformerConfig(**cfg)) == want
    for quant in ("int8", "none"):
        c = dict(cfg, decode_quant=quant)
        want = {k: _tp_dim(v)
                for k, v in j_decode_specs(JConfig(**c)).items()}
        assert tquant.decode_param_specs(TransformerConfig(**c)) == want
    assert tquant.decode_param_specs(TransformerConfig(
        **dict(cfg, decode_quant="none"))) == tmodel.param_specs(
        TransformerConfig(**dict(cfg, decode_quant="none")))


def test_quantize_on_the_mesh_takes_the_global_leaves():
    """A shard's scales are the (1, 1, 1) scales: the leaves are
    quantized whole whatever the mesh."""
    cfg = TransformerConfig(**CFG, decode_quant="int8", vocab_parallel=True)
    params = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    one = tquant.quantize_decode_params(params, cfg)
    mesh = tquant.quantize_decode_params(
        params, cfg, make_model_mesh(dp=2, tp=4, device="cpu"))
    assert set(one) == set(mesh)
    for k in one:
        assert torch.equal(one[k], mesh[k]), k
    with pytest.raises(ValueError, match="must divide over tp"):
        tquant.quantize_decode_params(
            params, cfg, make_model_mesh(tp=3, device="cpu"))


def test_mesh_refusals():
    cfg = TransformerConfig(**CFG)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompt = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="sp=1"):
        greedy_generate(params, prompt,
                        make_model_mesh(sp=2, device="cpu"), cfg, 2)
    two = tmodel.ModelMesh(dp=2, device="cpu", procs=2, proc=0)
    with pytest.raises(NotImplementedError, match="A5"):
        greedy_generate(params, prompt, two, cfg, 2)
    with pytest.raises(ValueError, match="does not shard over dp"):
        greedy_generate(params, torch.zeros((3, 4), dtype=torch.int32),
                        make_model_mesh(dp=2, device="cpu"), cfg, 2)


def test_decode_prefill_die_site():
    """JAX's ``test_chaos_decode.py::test_decode_prefill_die_site``: the
    first generate dies at the prefill boundary, the retry runs."""
    cfg = TransformerConfig(**CFG)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompt = torch.zeros((2, 8), dtype=torch.int32)
    mesh = make_model_mesh(dp=2, tp=2, device="cpu")
    assert "decode.prefill" in chaos.registered_sites()
    plan = chaos.FaultPlan(schedule={"die:decode.prefill": (0,)})
    with chaos.inject(plan):
        with pytest.raises(chaos.InjectedDeath):
            greedy_generate(params, prompt, mesh, cfg, 4)
        out = greedy_generate(params, prompt, mesh, cfg, 4)
    assert out.shape == (2, 12)
    assert plan.fired("die", "decode.prefill") == 1


def test_decode_bench_takes_jax_mesh_and_sampling_knobs():
    """``bench/decode.py``'s --dp/--tp/--sampling/--kv-heads: the metric
    names the mesh, the K/V heads and the sampling as JAX's does."""
    from icikit_torch.bench import decode as bench

    rec = bench.run_bench("tiny", 4, 8, 4, runs=1, windows=1, device="cpu",
                          dp=2, tp=2, sampling="sample", kv_heads=2)
    assert rec["metric"] == "decode_tiny_dp2tp2_b4_kv2_p8_n4_sample"
    assert rec["value"] > 0 and rec["unit"] == "tokens/s"
    assert bench.SAMPLE_KNOBS == dict(temperature=0.8, top_k=40)
    with pytest.raises(ValueError, match="sampling"):
        bench.run_bench("tiny", 4, 8, 4, device="cpu", sampling="beam")
    parsed = {}

    def fake(*args, **kw):
        parsed.update(kw)
        return {}

    orig, bench.run_bench = bench.run_bench, fake
    try:
        bench.main(["--device", "cpu", "--dp", "2", "--tp", "4",
                    "--sampling", "sample", "--kv-heads", "2"])
    finally:
        bench.run_bench = orig
    assert (parsed["dp"], parsed["tp"], parsed["sampling"],
            parsed["kv_heads"]) == (2, 4, "sample", 2)
