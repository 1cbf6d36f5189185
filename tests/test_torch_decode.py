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

int8 decode: the port's int8 tokens at float32 equal JAX's int8
``greedy_generate`` in its XLA form (``quant_matvec="xla"``,
``decode_step="unfused"``) bit for bit: JAX's int8 generate through its
Pallas kernels fails under the same vma check. The port's fused int8
step (its plain version here) is held to the port's unfused int8
tokens, the contract of JAX's
``test_fused_decode_step_q8_token_identity``.
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
                       (dict(draft_head=True), "draft_head")):
        with pytest.raises(NotImplementedError, match=what):
            init_params(TransformerConfig(**CFG, **over), gen, "cpu")
    # int8 decode is ported: its config initializes
    init_params(TransformerConfig(**CFG, decode_quant="int8"), gen, "cpu")
    cfg = TransformerConfig(**CFG)
    params = init_params(cfg, gen, "cpu")
    # decode on the mesh and sampled decode are ported: they run at dp
    # and tp > 1 (tests/test_torch_decode_mesh.py, test_torch_sampled.py
    # hold them to JAX)
    zeros = torch.zeros((2, 4), dtype=torch.int32)
    for dp, tp in ((2, 1), (1, 2)):
        m = make_model_mesh(dp=dp, tp=tp, device="cpu")
        assert greedy_generate(params, zeros, m, cfg, n_new=2).shape == (2, 6)
        assert sample_generate(params, zeros, m, cfg, 2,
                               np.zeros(2, np.uint32)).shape == (2, 6)
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


# ------------------------------------------------------------ int8 decode


def _jax_int8_tokens(cfg: dict, mesh, jparams, prompt, n_new):
    pd = jax.device_put(jnp.asarray(prompt),
                        NamedSharding(mesh, P("dp", None)))
    return np.asarray(j_generate(
        jparams, pd, mesh, JConfig(**cfg, decode_quant="int8",
                                   quant_matvec="xla",
                                   decode_step="unfused"), n_new=n_new))


@pytest.mark.parametrize("over", [dict(), dict(pos_encoding="rope"),
                                  dict(n_kv_heads=2, pos_encoding="rope")],
                         ids=["learned", "rope", "gqa"])
def test_int8_tokens_equal_jax_xla_form(over):
    """tests/test_decode.py's CFG (d_head 8), learned, RoPE and GQA: the
    port's int8 generate (every qmm impl; on the CPU each is the float32
    product then the scale) equals JAX's bit for bit."""
    cfg = dict(CFG, **over)
    mesh, jparams, prompt, tparams = _both(cfg, seed=4, batch=3)
    want = _jax_int8_tokens(cfg, mesh, jparams, prompt, 8)
    for impl in ("auto", "xla"):
        got = greedy_generate(tparams, torch.from_numpy(prompt),
                              make_model_mesh(device="cpu"),
                              TransformerConfig(**cfg, decode_quant="int8",
                                                quant_matvec=impl), n_new=8)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("pos_encoding", ["learned", "rope"])
def test_int8_fused_step_tokens_equal_unfused(pos_encoding):
    """tiny128 at float32: the port's fused int8 step (B14's plain
    version, with B15's through ``quant_matvec="pallas"``) gives the
    port's unfused int8 tokens, and both equal JAX's XLA-form int8
    generate."""
    from icikit.bench.train import PRESETS as J_PRESETS
    from icikit_torch.ops import cuda_quant

    cfg = dict(J_PRESETS["tiny128"], compute_dtype="float32",
               pos_encoding=pos_encoding)
    mesh, jparams, prompt, tparams = _both(cfg, seed=3)
    want = _jax_int8_tokens(cfg, mesh, jparams, prompt, 10)
    base = TransformerConfig(**cfg, decode_quant="int8")
    cuda_attention.reset_launches()
    cuda_quant.reset_launches()
    outs = {step: greedy_generate(
        tparams, torch.from_numpy(prompt), make_model_mesh(device="cpu"),
        TransformerConfig(**cfg, decode_quant="int8", decode_step=step,
                          quant_matvec="pallas"), n_new=10).numpy()
        for step in ("fused", "unfused")}
    assert set(cuda_attention.LAUNCHES.values()) == {0}   # CPU: plain
    assert cuda_quant.LAUNCHES["quant_matvec"] == 0
    np.testing.assert_array_equal(outs["fused"], outs["unfused"])
    np.testing.assert_array_equal(outs["fused"], want)
    # pre-quantized params give the same tokens
    from icikit_torch.models.transformer.decode import maybe_quantize_params
    mesh_t = make_model_mesh(device="cpu")
    qparams = maybe_quantize_params(tparams, mesh_t, base)
    assert maybe_quantize_params(qparams, mesh_t, base) is qparams
    np.testing.assert_array_equal(
        greedy_generate(qparams, torch.from_numpy(prompt), mesh_t,
                        TransformerConfig(**cfg, decode_quant="int8",
                                          decode_step="fused"),
                        n_new=10).numpy(), want)


@pytest.mark.parametrize("fused", [False, True])
def test_int8_caches_and_leaves_stay_int8(fused):
    """The prefill's caches are int8 with float32 scales, in the fused
    layout (b*h, total, dh) / (b*h, total) or the unfused one, and
    _DecodeCtx casts no int8 leaf and no scale."""
    from icikit.bench.train import PRESETS as J_PRESETS
    from icikit_torch.models.transformer.decode import (
        _DecodeCtx, _prefill, maybe_quantize_params)

    cfg = TransformerConfig(**J_PRESETS["tiny128"],
                            compute_dtype="bfloat16", decode_quant="int8")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    mesh = make_model_mesh(device="cpu")
    ctx = _DecodeCtx(cfg, maybe_quantize_params(params, mesh, cfg))
    for lp in ctx.layers:
        for k in ("wqkv", "wo", "w1", "w2"):
            assert lp[k].dtype == torch.int8, k
            assert lp[k + "_s"].dtype == torch.float32, k
        assert lp["ln1"].dtype == torch.float32
    assert ctx.w_out.dtype == torch.int8
    assert ctx.w_out_s.dtype == torch.float32
    b, s, total = 2, 8, 12
    prompt = torch.randint(0, cfg.vocab, (b, s), dtype=torch.int32)
    _, (kcs, vcs, kss, vss) = _prefill(ctx, prompt, s, total, fused)
    h, dh = cfg.n_heads, cfg.d_head
    shape = (b * h, total, dh) if fused else (b, total, h, dh)
    for c in kcs + vcs:
        assert c.dtype == torch.int8 and tuple(c.shape) == shape
        assert not bool(c[:, s:].any())
    for c in kss + vss:
        assert c.dtype == torch.float32 and tuple(c.shape) == shape[:-1]


def test_d_head_256_tokens_equal_jax_unfused():
    """A d_head-256 MHA config (the flash kernels' widest build, the
    decode gate's second width) through both step arms equals JAX."""
    cfg = dict(FUSED, d_head=256, pos_encoding="rope")
    mesh, jparams, prompt, tparams = _both(cfg, seed=5)
    want = _jax_tokens(cfg, mesh, jparams, prompt, 6)
    for step in ("fused", "unfused"):
        got = greedy_generate(tparams, torch.from_numpy(prompt),
                              make_model_mesh(device="cpu"),
                              TransformerConfig(**cfg, decode_step=step),
                              n_new=6)
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------- the int8 step's splits
# The kernel splits each row's past columns across CTAs and merges the
# splits' (max, sum, value) partials by log-sum-exp. Below: its split
# picker, and a plain model of the split-and-merge held to the port's
# plain int8 step and to JAX's ``decode_step_attention_q8`` (interpret
# mode, as JAX's own tests run it), within 1e-6 absolute (float32 sums in
# other orders; the int8 columns bit for bit).

from icikit.ops import flash_attention as jfa  # noqa: E402
from icikit.ops.quant import quantize_last as j_quantize_last  # noqa: E402


def test_decode_splits_picker():
    """Enough CTAs for two an SM at the int8 path's 64 rows (5 splits of
    ~109 columns at cur 543 on 132 SMs), no split under 16 columns, one
    where cur is under 16 (cur 0 included), never more splits than past
    columns, and one split a row once the rows alone fill the card."""
    ds = cuda_attention.decode_splits
    assert ds(64, 543, 132) == 5 and 64 * 5 >= 2 * 132
    assert ds(64, 575, 132) == 5 and ds(8, 543, 132) == 33
    assert ds(1, 4096, 132) == 256 and ds(1, 1 << 20, 132) == 264
    assert ds(264, 575, 132) == 1 and ds(1000, 575, 132) == 1
    for rows in (1, 8, 64, 300):
        for cur in range(0, 200):
            s = ds(rows, cur, 132)
            assert 1 <= s <= max(1, cur) and s * 16 <= max(16, cur)
            assert s == 1 or rows * s <= 2 * 132 + rows


def _q8_split_model(q, kq, vq, kdq, vdq, kc, vc, ks, vs, cur, scale,
                    splits):
    """The kernel's split-and-merge as whole-tensor ops: the int8 column
    written at cur; split j takes columns [j*span, min((j+1)*span,
    cur)), span = ceil(cur / splits), and keeps its max m_j, its sum l_j
    of exp(logit - m_j) and its values sum_t exp(logit_t - m_j) vscale_t
    v_t (an empty split: -inf, 0, 0); the merge adds the cur term from
    kdq, vdq."""
    kc[:, cur] = kq
    vc[:, cur] = vq
    qf = q.float()
    span = -(-cur // splits)
    parts = []
    for j in range(splits):
        t0, t1 = j * span, min((j + 1) * span, cur)
        if t1 <= t0:
            parts.append((torch.full((q.shape[0], 1), -torch.inf),
                          torch.zeros(q.shape[0], 1), torch.zeros_like(qf)))
            continue
        lg = (torch.einsum("rd,rtd->rt", qf, kc[:, t0:t1].float())
              * ks[:, t0:t1] * scale)
        m = lg.amax(-1, keepdim=True)
        e = torch.exp(lg - m)
        parts.append((m, e.sum(-1, keepdim=True), torch.einsum(
            "rt,rtd->rd", e * vs[:, t0:t1], vc[:, t0:t1].float())))
    lc = (qf * kdq.float()).sum(-1, keepdim=True) * scale
    mx = torch.stack([lc] + [m for m, _, _ in parts]).amax(0)
    ec = torch.exp(lc - mx)
    lt = ec + sum(l * torch.exp(m - mx) for m, l, _ in parts)
    acc = sum(a * torch.exp(m - mx) for m, _, a in parts)
    return (acc + ec * vdq.float()) / lt


def _q8_inputs(seed, rows, total, dh, cur):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((rows, dh)).astype(np.float32)
    kq, ksn = (np.asarray(a) for a in j_quantize_last(jnp.asarray(
        rng.standard_normal((rows, dh)).astype(np.float32))))
    vq, vsn = (np.asarray(a) for a in j_quantize_last(jnp.asarray(
        rng.standard_normal((rows, dh)).astype(np.float32))))
    kc, kcs = (np.array(a) for a in j_quantize_last(jnp.asarray(
        rng.standard_normal((rows, total, dh)).astype(np.float32))))
    vc, vcs = (np.array(a) for a in j_quantize_last(jnp.asarray(
        rng.standard_normal((rows, total, dh)).astype(np.float32))))
    kcs[:, cur], vcs[:, cur] = ksn, vsn
    kdq = kq.astype(np.float32) * ksn[:, None]
    vdq = vq.astype(np.float32) * vsn[:, None]
    return q, kq, vq, kdq, vdq, kc, vc, kcs, vcs


@pytest.mark.parametrize("cur", [0, 3, 40, 63])
def test_q8_split_merge_model_matches_plain_and_jax(cur):
    """At 1, 4 and 7 splits (empty splits where cur < splits, and at cur
    0), the split-and-merge gives the plain int8 step's output and JAX's
    within 1e-6, and writes the same int8 column."""
    rows, total, dh = 4, 64, 128
    args = _q8_inputs(cur, rows, total, dh, cur)
    scale = dh ** -0.5
    want_j, want_kc, want_vc = jfa.decode_step_attention_q8(
        *(jnp.asarray(a) for a in args), jnp.int32(cur), scale=scale)
    t = [torch.from_numpy(np.array(a)) for a in args]
    plain = cuda_attention.decode_step_q8_plain(
        *t[:5], t[5].clone(), t[6].clone(), *t[7:], cur, scale=scale)
    np.testing.assert_allclose(plain.numpy(), np.asarray(want_j), atol=1e-6,
                               rtol=0)
    for splits in (1, 4, 7):
        kc, vc = t[5].clone(), t[6].clone()
        got = _q8_split_model(*t[:5], kc, vc, *t[7:], cur, scale, splits)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want_j),
                                   atol=1e-6, rtol=0)
        np.testing.assert_array_equal(kc.numpy(), np.asarray(want_kc))
        np.testing.assert_array_equal(vc.numpy(), np.asarray(want_vc))


# ------------------------------------------- the bf16 step's splits
# B13's kernel splits a row's past columns as the int8 step does; each
# split rounds its weights exp(logit - m_j) to the cache dtype against
# its own max m_j before the value product, where JAX rounds against the
# row's max. Below: a plain model of that split-and-merge, at float32
# held to the port's plain step and JAX's ``decode_step_attention``
# (interpret mode) within 1e-5, at bf16 to the plain step within the
# card's bf16 tolerance, 2e-2; the written columns bit for bit.


def _split_model(q, k, v, kc, vc, cur, cos2, sin2, scale, rope, splits):
    """The split step as whole-tensor ops: q and k rotated and rounded to
    their dtype, the column written at cur; split j keeps its max m_j,
    its sum l_j of exp(logit - m_j) and its values sum_t w_t v_t with w_t
    = exp(logit_t - m_j) rounded to the cache dtype (an empty split:
    -inf, 0, 0); the merge adds the cur term (weight not rounded) by
    log-sum-exp and rounds the output to the dtype."""
    dt = q.dtype
    if rope:
        q = cuda_attention._rotate(q, cos2, sin2).to(dt)
        k = cuda_attention._rotate(k, cos2, sin2).to(dt)
    kc[:, cur] = k
    vc[:, cur] = v
    qf = q.float()
    span = -(-cur // splits)
    parts = []
    for j in range(splits):
        t0, t1 = j * span, min((j + 1) * span, cur)
        if t1 <= t0:
            parts.append((torch.full((q.shape[0], 1), -torch.inf),
                          torch.zeros(q.shape[0], 1), torch.zeros_like(qf)))
            continue
        lg = torch.einsum("rd,rtd->rt", qf, kc[:, t0:t1].float()) * scale
        m = lg.amax(-1, keepdim=True)
        e = torch.exp(lg - m)
        parts.append((m, e.sum(-1, keepdim=True), torch.einsum(
            "rt,rtd->rd", e.to(dt).float(), vc[:, t0:t1].float())))
    lc = (qf * k.float()).sum(-1, keepdim=True) * scale
    mx = torch.stack([lc] + [m for m, _, _ in parts]).amax(0)
    ec = torch.exp(lc - mx)
    lt = ec + sum(l * torch.exp(m - mx) for m, l, _ in parts)
    acc = sum(a * torch.exp(m - mx) for m, _, a in parts)
    return ((acc + ec * v.float()) / lt).to(dt)


@pytest.mark.parametrize("cur", [0, 3, 40, 63])
@pytest.mark.parametrize("rope", [True, False])
def test_split_step_model_matches_plain_and_jax(cur, rope):
    """At 1, 4 and 7 splits (empty splits where cur < splits, and at cur
    0): float32 within 1e-5 of the plain step and of JAX's, the columns
    bit for bit; bf16 within 2e-2 of the plain bf16 step, its columns bit
    for bit."""
    rows, total, dh = 4, 64, 128
    rng = np.random.default_rng(cur + 100 * rope)
    q, k, v = (rng.standard_normal((rows, dh)).astype(np.float32)
               for _ in range(3))
    kc, vc = (rng.standard_normal((rows, total, dh)).astype(np.float32)
              for _ in range(2))
    from icikit.ops.rope import rope_sincos as j_rope_sincos

    c, s = j_rope_sincos(jnp.asarray([cur]), dh, 10000.0)
    cos2 = np.asarray(jnp.concatenate([c, c], -1))
    sin2 = np.asarray(jnp.concatenate([s, s], -1))
    scale = dh ** -0.5
    want_j, want_kc, want_vc = jfa.decode_step_attention(
        *(jnp.asarray(a) for a in (q, k, v, kc, vc)), jnp.int32(cur),
        jnp.asarray(cos2), jnp.asarray(sin2), scale=scale, rope=rope)
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        t = [torch.from_numpy(np.array(a)).to(dt) for a in (q, k, v, kc, vc)]
        tc, ts = torch.from_numpy(cos2.copy()), torch.from_numpy(sin2.copy())
        kc_p, vc_p = t[3].clone(), t[4].clone()
        plain = cuda_attention.decode_step_plain(
            *t[:3], kc_p, vc_p, cur, tc, ts, scale=scale, rope=rope)
        for splits in (1, 4, 7):
            kc_m, vc_m = t[3].clone(), t[4].clone()
            got = _split_model(*t[:3], kc_m, vc_m, cur, tc, ts, scale, rope,
                               splits)
            np.testing.assert_allclose(got.float().numpy(),
                                       plain.float().numpy(), atol=tol,
                                       rtol=0)
            assert torch.equal(kc_m, kc_p) and torch.equal(vc_m, vc_p)
            if dt == torch.float32:
                np.testing.assert_allclose(got.numpy(), np.asarray(want_j),
                                           atol=tol, rtol=0)
                np.testing.assert_array_equal(kc_m.numpy(),
                                              np.asarray(want_kc))
                np.testing.assert_array_equal(vc_m.numpy(),
                                              np.asarray(want_vc))
