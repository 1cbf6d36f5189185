"""The port's train step against the JAX package's, on the CPU.

Both packages get the same weights (JAX's ``init_params``, carried over
by ``interop.params_from_jax``) and the same numpy tokens. At d_model
128 both take the fused cross-entropy head (JAX in Pallas interpret
mode, the port through its kernels' plain versions) and the flash
attention (d_head 32). Tolerances at float32: the loss 1e-5 relative
and every gradient leaf 1e-4 of its largest magnitude (float32 sums in
other orders through two layers); the losses of three ``FusedAdam``
steps 1e-5 relative. At bf16 the first-step loss 2e-2 relative: the two
frameworks round the bf16 residual stream at different places (XLA
keeps float32 inside its fusions), as the decode tests state.
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

from icikit.models.transformer import FusedAdam as JFusedAdam
from icikit.models.transformer import TransformerConfig as JConfig
from icikit.models.transformer import init_params as j_init_params
from icikit.models.transformer import make_train_step as j_make_train_step
from icikit.models.transformer.model import loss_and_metrics as j_loss
from icikit.models.transformer.model import make_model_mesh as j_mesh
from icikit_torch.interop import opt_state_from_jax, params_from_jax
from icikit_torch.models.transformer import (FusedAdam, TransformerConfig,
                                             loss_and_metrics, loss_fn,
                                             make_model_mesh,
                                             make_train_step)
from icikit_torch.ops import cuda_attention, cuda_xent

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CFG = dict(vocab=256, d_model=128, n_heads=4, d_head=32, d_ff=256,
           n_layers=2, max_seq=32, compute_dtype="float32",
           remat_policy="except_attn")
BATCH = 2


def _both(cfg: dict, seed: int = 0):
    """JAX mesh, params and numpy tokens/targets, and the port's copies
    of the params on the CPU."""
    mesh = j_mesh(dp=1, tp=1, sp=1)
    jparams = j_init_params(jax.random.key(seed), JConfig(**cfg), mesh)
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg["vocab"], (BATCH, cfg["max_seq"])
                       ).astype(np.int32)
    tgt = rng.integers(0, cfg["vocab"], (BATCH, cfg["max_seq"])
                       ).astype(np.int32)
    tparams = params_from_jax({k: np.asarray(v) for k, v in jparams.items()},
                              "cpu")
    return mesh, jparams, tok, tgt, tparams


def _port_loss(tparams, tok, tgt, cfg: dict):
    return loss_and_metrics(tparams, torch.from_numpy(tok),
                            torch.from_numpy(tgt),
                            make_model_mesh(device="cpu"),
                            TransformerConfig(**cfg))


@pytest.mark.parametrize("shift", [16.0, None])
@pytest.mark.parametrize("kv_heads", [0, 2])
@pytest.mark.parametrize("pos_encoding", ["learned", "rope"])
def test_loss_and_gradients_match_jax(pos_encoding, kv_heads, shift):
    cfg = dict(CFG, pos_encoding=pos_encoding, n_kv_heads=kv_heads,
               softmax_shift=shift)
    mesh, jparams, tok, tgt, tparams = _both(cfg, seed=kv_heads + 3)
    jl, jg, _ = j_loss(jparams, jnp.asarray(tok), jnp.asarray(tgt), mesh,
                       JConfig(**cfg))
    cuda_attention.reset_launches()
    cuda_xent.reset_launches()
    loss, grads, metrics = _port_loss(tparams, tok, tgt, cfg)
    assert set(cuda_attention.LAUNCHES.values()) == {0}
    assert set(cuda_xent.LAUNCHES.values()) == {0}
    assert metrics == {}
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert set(grads) == set(jg)
    for k, want in jg.items():
        want = np.asarray(want)
        assert grads[k].shape == want.shape, k
        np.testing.assert_allclose(grads[k].numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=k)



def test_loss_and_gradients_match_jax_at_d_head_256():
    """A d_head-256 MHA config (the widest flash build): loss and every
    gradient leaf as the d_head-32 cases, through the flash forward with
    the shift and its backward (plain versions here)."""
    cfg = dict(CFG, d_model=256, n_heads=2, d_head=256, pos_encoding="rope")
    mesh, jparams, tok, tgt, tparams = _both(cfg, seed=9)
    jl, jg, _ = j_loss(jparams, jnp.asarray(tok), jnp.asarray(tgt), mesh,
                       JConfig(**cfg))
    loss, grads, _ = _port_loss(tparams, tok, tgt, cfg)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for k, want in jg.items():
        want = np.asarray(want)
        np.testing.assert_allclose(grads[k].numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=k)

def _jax_steps(cfg, mesh, jparams, tok, tgt, mom, n):
    opt, step = j_make_train_step(mesh, JConfig(**cfg),
                                  JFusedAdam(1e-2, **mom))
    st = opt.init(jparams)
    losses = []
    for _ in range(n):
        jparams, st, loss = step(jparams, st, jnp.asarray(tok),
                                 jnp.asarray(tgt))
        losses.append(float(loss))
    return losses, jparams, st


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_three_fused_adam_steps_match_jax(moments):
    cfg = dict(CFG, pos_encoding="rope")
    mesh, jparams, tok, tgt, tparams = _both(cfg, seed=7)
    jmom = ({} if moments == "float32"
            else dict(mu_dtype=jnp.bfloat16, nu_dtype=jnp.bfloat16))
    tmom = ({} if moments == "float32"
            else dict(mu_dtype=torch.bfloat16, nu_dtype=torch.bfloat16))
    want, jp, _ = _jax_steps(cfg, mesh, jparams, tok, tgt, jmom, 3)
    opt, step = make_train_step(make_model_mesh(device="cpu"),
                                TransformerConfig(**cfg),
                                FusedAdam(1e-2, **tmom))
    st = opt.init(tparams)
    got = []
    for _ in range(3):
        tparams, st, loss = step(tparams, st, torch.from_numpy(tok),
                                 torch.from_numpy(tgt))
        got.append(float(loss))
    assert int(st[2]) == 3
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[2] < got[0]
    for k, v in jp.items():
        np.testing.assert_allclose(tparams[k].numpy(), np.asarray(v),
                                   rtol=0, atol=1e-4, err_msg=k)


# The train step's other arms: the recompute head (B10 recompute), the
# matmul head backward with the saved and the recomputed g (B11), and the
# one-pass Adam kernel (B12), each against JAX's same arm.
ARMS = {"head-recompute": (dict(xent_save_exp=False), False),
        "hb-matmul-saved": (dict(xent_fused_bwd=False), False),
        "hb-matmul-recompute": (dict(xent_save_exp=False,
                                     xent_fused_bwd=False), False),
        "adam-kernel": (dict(), True)}


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_train_arms_match_jax(arm):
    """Three steps of each arm against JAX's (its Pallas kernels in
    interpret mode, the port's plain versions), float32: the losses 1e-5
    relative and each parameter leaf 1e-5 in relative L2 (Adam divides
    each entry's step by its own gradient scale, so an entry whose
    gradient sits at the float32 noise of the two frameworks' sums moves
    by up to lr = 1e-2 either way: one entry in 65536 here moves 1.4e-4,
    so an entrywise bound would hold only by luck). JAX's step with its
    Pallas Adam fails on jax 0.9.0 in interpret mode under shard_map (the
    vma check, as its fused decode does), so the Adam kernel's arm is
    held against JAX's XLA Adam, the same function (``tests/test_torch_adam.py`` holds the kernel's route
    against JAX's Pallas kernel called directly)."""
    over, pallas = ARMS[arm]
    cfg = dict(CFG, pos_encoding="rope", **over)
    mesh, jparams, tok, tgt, tparams = _both(cfg, seed=13)
    opt, jstep = j_make_train_step(mesh, JConfig(**cfg), JFusedAdam(1e-2))
    jst = opt.init(jparams)
    want = []
    for _ in range(3):
        jparams, jst, loss = jstep(jparams, jst, jnp.asarray(tok),
                                   jnp.asarray(tgt))
        want.append(float(loss))
    opt, step = make_train_step(make_model_mesh(device="cpu"),
                                TransformerConfig(**cfg),
                                FusedAdam(1e-2, use_pallas=pallas))
    st = opt.init(tparams)
    got = []
    for _ in range(3):
        tparams, st, loss = step(tparams, st, torch.from_numpy(tok),
                                 torch.from_numpy(tgt))
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[2] < got[0]
    for k, v in jparams.items():
        a, b = tparams[k].double().numpy(), np.asarray(v, np.float64)
        assert np.linalg.norm(a - b) <= 1e-5 * np.linalg.norm(b), k


def test_step_from_carried_jax_state_matches_jax():
    """One step from JAX's optimizer state after two steps (non-zero
    moments, t = 2), carried over by ``opt_state_from_jax``."""
    cfg = dict(CFG)
    mesh, jparams, tok, tgt, _ = _both(cfg, seed=11)
    _, jp, jst = _jax_steps(cfg, mesh, jparams, tok, tgt, {}, 2)
    opt, jstep = j_make_train_step(mesh, JConfig(**cfg), JFusedAdam(1e-2))
    _, _, jloss = jstep(jp, jst, jnp.asarray(tok), jnp.asarray(tgt))
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    st = opt_state_from_jax(
        ({k: np.asarray(v) for k, v in jst[0].items()},
         {k: np.asarray(v) for k, v in jst[1].items()},
         np.asarray(jst[2])), "cpu")
    _, step = make_train_step(make_model_mesh(device="cpu"),
                              TransformerConfig(**cfg), FusedAdam(1e-2))
    tp, st, loss = step(tp, st, torch.from_numpy(tok), torch.from_numpy(tgt))
    assert int(st[2]) == 3
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


def test_remat_policies_give_identical_gradients():
    base = dict(CFG, pos_encoding="rope", n_kv_heads=2)
    _, _, tok, tgt, tparams = _both(base, seed=5)
    runs = [_port_loss(tparams, tok, tgt, dict(base, **over))
            for over in (dict(remat=False), dict(remat_policy="nothing"),
                         dict(remat_policy="except_attn"))]
    runs.append((*loss_fn(tparams, torch.from_numpy(tok),
                          torch.from_numpy(tgt),
                          make_model_mesh(device="cpu"),
                          TransformerConfig(**base)), {}))
    for loss, grads, _ in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        for k, g in grads.items():
            assert torch.equal(g, runs[0][1][k]), k


def test_device_guard_skips_a_non_finite_step():
    cfg = dict(CFG)
    _, _, tok, tgt, tparams = _both(cfg, seed=2)
    opt, step = make_train_step(make_model_mesh(device="cpu"),
                                TransformerConfig(**cfg), FusedAdam(1e-2),
                                guard="device")
    st = opt.init(tparams)
    tparams, st, loss, ok = step(tparams, st, torch.from_numpy(tok),
                                 torch.from_numpy(tgt))
    assert bool(ok) and int(st[2]) == 1
    tparams["w1"][0, 0, 0] = float("nan")
    before = {k: v.clone() for k, v in tparams.items()}
    m_before = {k: v.clone() for k, v in st[0].items()}
    tparams, st, loss, ok = step(tparams, st, torch.from_numpy(tok),
                                 torch.from_numpy(tgt))
    assert not bool(ok) and int(st[2]) == 1
    for k, v in before.items():
        assert torch.equal(tparams[k], v) or k == "w1", k
        assert torch.equal(st[0][k], m_before[k]), k
    assert torch.isnan(tparams["w1"][0, 0, 0])


def test_bfloat16_first_step_loss_near_jax():
    cfg = dict(CFG, compute_dtype="bfloat16", pos_encoding="rope")
    mesh, jparams, tok, tgt, tparams = _both(cfg, seed=4)
    jl, jg, _ = j_loss(jparams, jnp.asarray(tok), jnp.asarray(tgt), mesh,
                       JConfig(**cfg))
    want, _, _ = _jax_steps(cfg, mesh, jparams, tok, tgt,
                            dict(mu_dtype=jnp.bfloat16,
                                 nu_dtype=jnp.bfloat16), 1)
    opt, step = make_train_step(
        make_model_mesh(device="cpu"), TransformerConfig(**cfg),
        FusedAdam(1e-2, mu_dtype=torch.bfloat16, nu_dtype=torch.bfloat16))
    st = opt.init(tparams)
    tparams, st, loss = step(tparams, st, torch.from_numpy(tok),
                             torch.from_numpy(tgt))
    np.testing.assert_allclose(float(loss), float(jl), rtol=2e-2)
    np.testing.assert_allclose(float(loss), want[0], rtol=2e-2)
    # grad_dtype="compute": the matmul weights' gradients are bf16
    _, grads, _ = loss_and_metrics(
        {k: v.to(torch.bfloat16) if k in ("wqkv", "wo", "w1", "w2",
                                          "w_out") else v
         for k, v in tparams.items()},
        torch.from_numpy(tok), torch.from_numpy(tgt),
        make_model_mesh(device="cpu"), TransformerConfig(**cfg))
    assert grads["w1"].dtype == torch.bfloat16
    assert grads["ln1"].dtype == torch.float32
    assert st[0]["w1"].dtype == torch.bfloat16


def test_train_refusals_name_their_items():
    mesh = make_model_mesh(device="cpu")
    for over, what in ((dict(vocab_parallel=True), "A5"),
                       (dict(remat_policy="dots_attn"), "A8")):
        with pytest.raises(NotImplementedError, match=what):
            make_train_step(mesh, TransformerConfig(**dict(CFG, **over)))
    # the save stack (B16) is ported: its step builds and runs
    _, _, tok, tgt, tparams = _both(CFG, seed=1)
    opt, step = make_train_step(
        mesh, TransformerConfig(**dict(CFG, save_stack="pallas")))
    _, st, loss = step(tparams, opt.init(tparams), torch.from_numpy(tok),
                       torch.from_numpy(tgt))
    assert int(st[2]) == 1 and np.isfinite(float(loss))
    with pytest.raises(ValueError, match="unknown remat_policy"):
        make_train_step(mesh, TransformerConfig(remat_policy="all"))
    # the one-pass Adam kernel (B12) and the head's other flavours (B10
    # recompute, B11) are ported: their steps build and run
    for cfg_over, adam in ((dict(), FusedAdam(use_pallas=True)),
                           (dict(xent_save_exp=False), None),
                           (dict(xent_fused_bwd=False), None)):
        opt, step = make_train_step(
            mesh, TransformerConfig(**dict(CFG, **cfg_over)), adam)
        assert opt.use_pallas == (adam is not None)
    with pytest.raises(NotImplementedError, match="A5"):
        make_train_step(mesh, TransformerConfig(**CFG), guard="device",
                        grad_check="ring")
    with pytest.raises(ValueError, match="grad_check needs"):
        make_train_step(mesh, TransformerConfig(**CFG), grad_check="ring")
    opt, _ = make_train_step(mesh, TransformerConfig(**CFG))
    assert isinstance(opt, FusedAdam) and opt.lr == 3e-4


def test_step_flops_and_peaks_match_jax():
    from icikit.bench.train import step_flops as j_flops
    from icikit_torch.bench.train import (PRESETS, detect_peak,
                                          measure_peak, peak_key,
                                          step_flops)

    cfg = TransformerConfig(**PRESETS["base"])
    assert step_flops(cfg, 8, 1024) == j_flops(JConfig(**PRESETS["base"]),
                                               8, 1024)
    assert round(step_flops(cfg, 8, 1024) / 1e13, 3) == 1.196
    assert peak_key("NVIDIA H100 80GB HBM3") == "H100 SXM"
    assert peak_key("NVIDIA H100 PCIe") == "H100 PCIe"
    assert peak_key("NVIDIA A100-SXM4-80GB") is None
    assert detect_peak("cpu") == 0.0
    assert measure_peak(n=64, iters=2, device="cpu") > 0


BENCH_KEYS = {"metric", "value", "unit", "step_ms", "model_tflops_per_s",
              "mfu", "loss", "protocol", "windows", "discarded",
              "session_quality", "step_ms_spread", "optimizer", "head",
              "head_bwd", "softmax_shift", "save_stack", "device",
              "power_limit"}


def test_train_bench_runs_on_cpu_with_jax_record_keys():
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-m", "icikit_torch.bench.train",
                        "--device", "cpu", "--preset", "tiny", "--batch",
                        "2", "--steps", "2", "--warmup", "1", "--windows",
                        "1"], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert BENCH_KEYS <= set(rec)
    assert rec["metric"] == "train_tiny_dp1tp1sp1_b2_rp-except_attn"
    assert rec["head"] == "saved" and rec["mfu"] is None
    assert rec["device"] == "cpu" and np.isfinite(rec["loss"])
    for flags, tag in ((["--head", "recompute"], "_head-recompute"),
                       (["--head-bwd", "matmul"], "_hb-matmul"),
                       (["--optimizer", "fused-pallas"],
                        "_opt-fused-pallas")):
        r = subprocess.run([sys.executable, "-m", "icikit_torch.bench.train",
                            "--device", "cpu", "--preset", "tiny", "--batch",
                            "2", "--steps", "1", "--warmup", "1",
                            "--windows", "1", *flags], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr
        rec = json.loads(r.stdout.strip().splitlines()[-1])
        assert rec["metric"].endswith(tag) and np.isfinite(rec["loss"])
    r = subprocess.run([sys.executable, "-m", "icikit_torch.bench.train",
                        "--device", "cpu", "--preset", "tiny", "--dp", "2"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and "A5" in r.stderr
