"""The port's model mesh against the JAX package's, on the CPU.

Both packages get the same weights (JAX's ``init_params``, carried over
by ``interop.params_from_jax``: a leaf is its global array on any mesh)
and the same seeded numpy tokens; JAX runs its sharded ``loss_fn`` on
its simulated 8-device mesh, the port its rank-vectorised one. The
configs are JAX's tests' (``test_transformer.py``'s tiny ``CFG``,
``test_vocab_parallel.py``'s, ``test_model_schedules.py``'s,
``test_zigzag.py``'s) and the tolerances JAX's own: the loss 1e-5
relative, every gradient leaf 2e-4 relative and 2e-5 absolute. Then the
train step on the mesh against JAX's, the checked gradient ring (a clean
step commits as the unchecked one, a drilled one commits nothing), two
real OS processes splitting dp (bitwise the one-process step), and
decode on a dp/tp mesh (it runs in one process, refuses across
processes).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from icikit.models.transformer import FusedAdam as JFusedAdam
from icikit.models.transformer import TransformerConfig as JConfig
from icikit.models.transformer import init_params as j_init_params
from icikit.models.transformer import loss_fn as j_loss_fn
from icikit.models.transformer import make_train_step as j_make_train_step
from icikit.models.transformer import model as jmodel
from icikit_torch import chaos
from icikit_torch.examples import multihost as mh
from icikit_torch.interop import params_from_jax
from icikit_torch.models.transformer import (FusedAdam, TransformerConfig,
                                             greedy_generate, init_params,
                                             loss_fn, make_model_mesh,
                                             make_train_step)
from icikit_torch.models.transformer import model as tmodel
from icikit_torch.models.transformer.quant import quantize_decode_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# test_transformer.py's CFG
CFG = dict(vocab=61, d_model=32, n_heads=4, d_head=8, d_ff=64, n_layers=2,
           max_seq=32, compute_dtype="float32")


def _batch(vocab, b=8, s=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, size=(b, s)).astype(np.int32),
            rng.integers(0, vocab, size=(b, s)).astype(np.int32))


def _both_losses(cfg: dict, mesh: tuple, tok, tgt, jax_over=None):
    """JAX's sharded loss and gradients and the port's at ``mesh``, on
    JAX's init. ``jax_over`` changes JAX's config only (an arm whose
    JAX form does not run here)."""
    dp, tp, sp = mesh
    jm = jmodel.make_model_mesh(dp=dp, tp=tp, sp=sp)
    jcfg = JConfig(**{**cfg, **(jax_over or {})})
    jp = j_init_params(jax.random.key(0), jcfg, jm)
    sh = NamedSharding(jm, P("dp", "sp"))
    jl, jg = j_loss_fn(jp, jax.device_put(jnp.asarray(tok), sh),
                       jax.device_put(jnp.asarray(tgt), sh), jm, jcfg)
    tparams = params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                              "cpu")
    tl, tg = loss_fn(tparams, torch.from_numpy(tok), torch.from_numpy(tgt),
                     make_model_mesh(dp, tp, sp, device="cpu"),
                     TransformerConfig(**cfg))
    return (float(jl), {k: np.asarray(v) for k, v in jg.items()}), \
        (float(tl), {k: v.numpy() for k, v in tg.items()})


def _match(want, got, rtol=1e-5, grad_rtol=2e-4, grad_atol=2e-5):
    (jl, jg), (tl, tg) = want, got
    np.testing.assert_allclose(tl, jl, rtol=rtol)
    assert set(tg) == set(jg)
    for k, w in jg.items():
        assert tg[k].shape == w.shape, k
        np.testing.assert_allclose(tg[k], w, rtol=grad_rtol,
                                   atol=grad_atol, err_msg=k)


@pytest.mark.parametrize("mesh", [(2, 2, 2), (1, 4, 2), (2, 1, 4),
                                  (8, 1, 1)])
def test_mesh_loss_and_gradients_match_jax(mesh):
    """test_transformer.py's meshes and data: the ring schedule over sp,
    heads and d_ff over tp, the batch over dp."""
    tok, tgt = _batch(CFG["vocab"])
    _match(*_both_losses(CFG, mesh, tok, tgt))


@pytest.mark.parametrize("over,mesh", [
    (dict(sequence_schedule="zigzag"), (1, 1, 4)),
    (dict(sequence_schedule="ulysses"), (2, 1, 4)),
    (dict(sequence_schedule="ulysses", sp_algorithm="wraparound"),
     (1, 2, 2)),
    (dict(n_kv_heads=2, pos_encoding="rope"), (2, 2, 2)),
    (dict(n_kv_heads=2, pos_encoding="rope",
          sequence_schedule="zigzag"), (1, 2, 4)),
], ids=["zigzag-114", "ulysses-214", "ulysses-wrap-122",
        "gqa-rope-222", "gqa-rope-zigzag-124"])
def test_mesh_schedules_match_jax(over, mesh):
    """The sp schedules in the model (test_model_schedules.py's and
    test_zigzag.py's meshes), and GQA with RoPE at global positions."""
    cfg = dict(CFG, **over)
    tok, tgt = _batch(cfg["vocab"], b=4, s=32, seed=1)
    _match(*_both_losses(cfg, mesh, tok, tgt))


@pytest.mark.parametrize("mesh", [(1, 4, 1), (2, 2, 2)])
def test_vocab_parallel_head_matches_jax(mesh):
    """test_vocab_parallel.py's config and meshes: w_out's vocabulary
    over tp, the distributed cross-entropy."""
    cfg = dict(CFG, vocab=64, vocab_parallel=True)
    tok, tgt = _batch(64, b=4, s=32)
    _match(*_both_losses(cfg, mesh, tok, tgt), rtol=2e-5, grad_rtol=5e-4,
           grad_atol=5e-5)


@pytest.mark.parametrize("over", [{}, dict(save_stack="pallas"),
                                  dict(xent_fused_bwd=False)],
                         ids=["fused-head", "save-stack", "matmul-head"])
def test_mesh_fused_head_arms_match_jax(over):
    """At d_model 128 the fused head runs, one call a rank on that
    rank's copy of w_out; the save stack and the matmul head backward
    on the mesh. JAX's Pallas save stack fails under shard_map on this
    image, so that arm is held to JAX's ``save_stack="xla"``."""
    cfg = dict(vocab=256, d_model=128, n_heads=4, d_head=32, d_ff=256,
               n_layers=2, max_seq=32, compute_dtype="float32",
               remat_policy="except_attn", **over)
    tok, tgt = _batch(256, b=4, s=32, seed=2)
    _match(*_both_losses(cfg, (2, 2, 2), tok, tgt,
                         jax_over=dict(save_stack="xla")))


def test_mesh_train_steps_match_jax():
    """Three FusedAdam steps at (2, 2, 2): the losses JAX's step gives
    on its mesh (JAX's Adam under shard_map, the port's on the global
    leaves)."""
    cfg = dict(CFG, remat_policy="except_attn")
    tok, tgt = _batch(CFG["vocab"], seed=3)
    jm = jmodel.make_model_mesh(dp=2, tp=2, sp=2)
    jp = j_init_params(jax.random.key(5), JConfig(**cfg), jm)
    tp_ = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    opt, step = j_make_train_step(jm, JConfig(**cfg), JFusedAdam(1e-2))
    st = opt.init(jp)
    sh = NamedSharding(jm, P("dp", "sp"))
    jt, jy = (jax.device_put(jnp.asarray(x), sh) for x in (tok, tgt))
    want = []
    for _ in range(3):
        jp, st, loss = step(jp, st, jt, jy)
        want.append(float(loss))
    topt, tstep = make_train_step(make_model_mesh(2, 2, 2, device="cpu"),
                                  TransformerConfig(**cfg), FusedAdam(1e-2))
    tst = topt.init(tp_)
    got = []
    for _ in range(3):
        tp_, tst, loss = tstep(tp_, tst, torch.from_numpy(tok),
                               torch.from_numpy(tgt))
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("over,mesh,msg", [
    (dict(), (1, 3, 1), "n_heads=4 must divide over tp=3"),
    (dict(n_kv_heads=2), (1, 4, 1), "n_kv_heads=2 must divide over tp=4"),
    (dict(vocab_parallel=True), (1, 2, 1), "vocab_parallel requires"),
    (dict(sequence_schedule="ulysses"), (1, 2, 4), "ulysses needs"),
    (dict(sequence_schedule="zigzag", max_seq=36), (1, 1, 4),
     "zigzag needs"),
])
def test_mesh_validation_matches_jax(over, mesh, msg):
    cfg = dict(CFG, **over)
    dp, tp, sp = mesh
    with pytest.raises(ValueError, match=msg):
        j_init_params(jax.random.key(0), JConfig(**cfg),
                      jmodel.make_model_mesh(dp=dp, tp=tp, sp=sp))
    tmesh = make_model_mesh(dp, tp, sp, device="cpu")
    with pytest.raises(ValueError, match=msg):
        init_params(TransformerConfig(**cfg), torch.Generator(), "cpu",
                    tmesh)
    with pytest.raises(ValueError, match=msg):
        make_train_step(tmesh, TransformerConfig(**cfg))


def test_mesh_shapes_init_and_specs():
    """Any product of dp, tp, sp is a mesh; init on any mesh gives the
    (1, 1, 1) values; every leaf has a tp verdict, JAX's."""
    with pytest.raises(ValueError, match="positive"):
        make_model_mesh(dp=0, device="cpu")
    mesh = make_model_mesh(3, 2, 1, device="cpu")
    assert mesh.shape == {"dp": 3, "tp": 2, "sp": 1} and mesh.size == 6
    assert mesh.local == (0, 3) and mesh.local_size("dp") == 3
    cfg = TransformerConfig(**CFG)
    one = init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    meshed = init_params(cfg, torch.Generator().manual_seed(4), "cpu",
                         make_model_mesh(2, 2, 2, device="cpu"))
    assert all(torch.equal(one[k], meshed[k]) for k in one)
    for over in ({}, dict(n_kv_heads=2, pos_encoding="rope",
                          vocab_parallel=True)):
        c = dict(CFG, **over)
        specs = tmodel.param_specs(TransformerConfig(**c))
        jspecs = jmodel.param_specs(JConfig(**c))
        assert set(specs) == set(jspecs)
        for k, dim in specs.items():
            want = [i for i, a in enumerate(jspecs[k]) if a == "tp"]
            assert ([dim] if dim is not None else []) == want, k
    for m in ((2, 1, 1), (4, 2, 1), (1, 2, 2)):
        assert tmodel.grad_sync_n_steps(make_model_mesh(*m, device="cpu")) \
            == jmodel.grad_sync_n_steps(jmodel.make_model_mesh(
                dp=m[0], tp=m[1], sp=m[2]))


# -- the checked gradient ring (test_integrity.py's set-up) -------------

RING_CFG = dict(vocab=32, d_model=32, n_heads=2, d_head=8, d_ff=64,
                n_layers=1, max_seq=16, compute_dtype="float32")


def _ring_setup(grad_check, mesh=(2, 1, 1)):
    cfg = TransformerConfig(**RING_CFG)
    m = make_model_mesh(*mesh, device="cpu")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu", m)
    opt, step = make_train_step(m, cfg, guard="device",
                                grad_check=grad_check)
    rng = np.random.default_rng(0)
    tok, tgt = (torch.from_numpy(rng.integers(0, 32, (4, 16)))
                for _ in range(2))
    return params, opt.init(params), step, tok, tgt


@pytest.mark.parametrize("mesh", [(2, 1, 1), (4, 2, 1)])
def test_checked_step_bitwise_matches_unchecked_on_clean_runs(mesh):
    params, state, step, tok, tgt = _ring_setup("ring", mesh)
    params2, state2, plain, _, _ = _ring_setup("none", mesh)
    out = step(params, state, tok, tgt, chaos.TAINT_OFF)
    ref = plain(params2, state2, tok, tgt)
    assert bool(out[3]) and torch.equal(out[2], ref[2])
    for k in out[0]:
        assert torch.equal(out[0][k], ref[0][k]), k
    assert int(out[1][2]) == 1


def test_corrupted_grad_sync_skips_the_commit():
    params, state, step, tok, tgt = _ring_setup("ring")
    before = {k: v.clone() for k, v in params.items()}
    m_before = {k: v.clone() for k, v in state[0].items()}
    plan = chaos.FaultPlan(
        seed=2, schedule={f"corrupt:{tmodel.GRAD_SYNC_SITE}": (0,)})
    with chaos.inject(plan):
        taint = chaos.traced_corrupt_spec(tmodel.GRAD_SYNC_SITE, 1, 2)
    assert plan.fired("corrupt", tmodel.GRAD_SYNC_SITE) == 1
    p_bad, st_bad, _, ok = step(params, state, tok, tgt, taint)
    assert not bool(ok)
    # the where(ok, new, old) select held everything
    for k in before:
        assert torch.equal(p_bad[k], before[k]), k
        assert torch.equal(st_bad[0][k], m_before[k]), k
    assert int(st_bad[2]) == 0
    # the next clean step commits
    _, st_ok, _, ok = step(p_bad, st_bad, tok, tgt)
    assert bool(ok) and int(st_ok[2]) == 1


# -- dp across two OS processes -----------------------------------------


def test_two_process_dp2_step_is_bitwise_the_one_process_step(tmp_path):
    """Two OS processes on gloo, one dp rank each: the gradient psum and
    the loss psum over dp cross the process backend, and each process's
    loss, first-step gradients and stepped parameters equal the
    one-process dp = 2 step's bit for bit (a two-term sum is exact in
    either order). Skips when no local port can be bound or the
    coordinator port lost three races."""
    from icikit_torch.utils.net import PORT_RACE_SIGS

    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("XLA_FLAGS", None)
    try:
        res = mh.launch(mh.train_argv("cpu", str(tmp_path)),
                        str(tmp_path), timeout=180, env=env, cwd=ROOT)
    except OSError as e:  # pragma: no cover - environmental
        pytest.skip(f"cannot bind a local port: {e}")
    outs = "\n".join(o for _, o in res)
    if any(c != 0 for c, _ in res) and any(s in outs for s in
                                           PORT_RACE_SIGS):
        pytest.skip("coordinator port kept colliding across 3 fresh "
                    "ports (busy host)")  # pragma: no cover
    for code, out in res:
        assert code == 0, out[-3000:]
    recs = [mh.worker_result(o) for _, o in res]
    assert [r["dp_ranks"] for r in recs] == [[0, 1], [1, 2]]
    assert all(r["wire"]["collectives"] > 0 for r in recs)
    one, _ = mh.train_case(make_model_mesh(*mh.TRAIN_MESH, device="cpu"))
    for i in range(2):
        got = np.load(tmp_path / f"rank{i}.npz")
        assert set(got) == set(one)
        for k, v in one.items():
            assert np.array_equal(np.ascontiguousarray(got[k]).view(np.uint8),
                                  np.ascontiguousarray(v).view(np.uint8)), k


# -- decode on the mesh: runs in one process, refuses across processes ----
# (tests/test_torch_decode_mesh.py holds it to JAX's generate)


@pytest.mark.parametrize("mesh", [(2, 1, 1), (1, 2, 1)])
def test_decode_on_a_dp_or_tp_mesh_refuses(mesh):
    cfg = TransformerConfig(**dict(CFG, decode_quant="int8"))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    m = make_model_mesh(*mesh, device="cpu")
    prompt = torch.zeros((2, 4), dtype=torch.int32)
    want = greedy_generate(params, prompt, make_model_mesh(device="cpu"),
                           cfg, n_new=2)
    assert torch.equal(greedy_generate(params, prompt, m, cfg, n_new=2),
                       want)
    q = quantize_decode_params(params, cfg, m)
    assert all(torch.equal(v, w) for v, w in zip(
        q.values(), quantize_decode_params(params, cfg).values()))
    # what still refuses: dp ranks spread over processes (ROADMAP A5)
    two = tmodel.ModelMesh(2, mesh[1], 1, device="cpu", procs=2, proc=1)
    with pytest.raises(NotImplementedError, match="A5"):
        greedy_generate(params, prompt, two, cfg, n_new=2)
