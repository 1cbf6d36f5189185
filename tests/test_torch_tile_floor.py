"""The tile-floor study (B17) against the JAX package's, on the CPU.

The port's plain versions of its two kernels, ``mxu_plain`` and
``ablate_plain`` (four variants), against JAX's ``_mxu_kernel`` and
``_ablate_kernel`` run through a ``pl.pallas_call`` built here with
``measure``'s BlockSpecs, in interpret mode, on the same numpy-seeded
bf16 inputs at the port's geometry (seq 256, h 1, d 64, bq = bk = 64).
Tolerance 1e-2 of the largest entry, compared in float32: both round
``w`` to bf16 before the value product, and a score that lands on a bf16
rounding boundary in one framework's float32 sum rounds the other way in
the other; the bf16 output is the last rounding. Then ``measure`` and
``render`` on the CPU, as JAX's ``tests/test_tile_floor.py`` runs its
own.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from icikit.bench.tile_floor import _ablate_kernel, _mxu_kernel
from icikit_torch.bench.tile_floor import (ABLATIONS, LOG2E_JAX, measure,
                                           render)
from icikit_torch.interop import from_jax
from icikit_torch.ops import cuda_tile_floor as ctf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ, H, D, TILE = 256, 1, 64, 64


def _inputs(seed: int):
    rng = np.random.default_rng(seed)
    return [jnp.asarray(rng.standard_normal((1, H, SEQ, D)), jnp.bfloat16)
            for _ in range(3)]


def _jax_call(kernel, scratch, q, k, v):
    """``kernel`` through ``measure``'s grid and BlockSpecs
    (``icikit/bench/tile_floor.py:174-187``), interpreted."""
    nq = nk = SEQ // TILE
    spec_q = pl.BlockSpec((1, 1, TILE, D),
                          lambda ib, ih, iq, ik: (ib, ih, iq, 0))
    spec_k = pl.BlockSpec((1, 1, TILE, D),
                          lambda ib, ih, iq, ik: (ib, ih, ik, 0))
    return pl.pallas_call(
        partial(kernel, nk=nk),
        grid=(1, H, nq, nk),
        in_specs=[spec_q, spec_k, spec_k],
        out_specs=spec_q,
        out_shape=jax.ShapeDtypeStruct((1, H, SEQ, D), jnp.bfloat16),
        scratch_shapes=scratch,
        interpret=True,
    )(q, k, v)


VARIANTS = [("mxu", None, None)] + list(ABLATIONS)


@pytest.mark.parametrize("variant,use_exp2,use_max", VARIANTS)
def test_plain_versions_match_jax_kernels(variant, use_exp2, use_max):
    q, k, v = _inputs(seed=len(variant))
    scale_log2 = D ** -0.5 * LOG2E_JAX
    if variant == "mxu":
        want = _jax_call(partial(_mxu_kernel, scale=scale_log2),
                         [pltpu.VMEM((TILE, D), jnp.float32)], q, k, v)
    else:
        want = _jax_call(
            partial(_ablate_kernel, scale=scale_log2, use_exp2=use_exp2,
                    use_max=use_max),
            [pltpu.VMEM((TILE, 128), jnp.float32),
             pltpu.VMEM((TILE, 128), jnp.float32),
             pltpu.VMEM((TILE, D), jnp.float32)], q, k, v)
    tq, tk, tv = (from_jax(np.asarray(a)) for a in (q, k, v))
    ctf.reset_launches()
    if variant == "mxu":
        got = ctf.tile_mxu(tq, tk, tv, scale_log2)
        plain = ctf.mxu_plain(tq, tk, tv, scale_log2, bk=TILE)
    else:
        got = ctf.tile_ablate(tq, tk, tv, scale_log2, use_exp2, use_max)
        plain = ctf.ablate_plain(tq, tk, tv, scale_log2, use_exp2, use_max,
                                 bk=TILE)
    assert set(ctf.LAUNCHES.values()) == {0}     # CPU: the plain version
    assert got.dtype == torch.bfloat16 and torch.equal(got, plain)
    want = np.asarray(want, np.float32)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=1e-2 * np.abs(want).max())


def test_plain_versions_follow_the_key_tile():
    """The ablations depend on the key tile (alpha and the constant max
    act per tile), so the plain version takes ``bk``; mxu does not."""
    q, k, v = (from_jax(np.asarray(a)) for a in _inputs(seed=3))
    s = D ** -0.5 * LOG2E_JAX
    assert not torch.equal(ctf.ablate_plain(q, k, v, s, False, True),
                           ctf.ablate_plain(q, k, v, s, False, True, bk=128))
    a, b = ctf.mxu_plain(q, k, v, s), ctf.mxu_plain(q, k, v, s, bk=128)
    assert float((a.float() - b.float()).abs().max()) \
        <= 1e-2 * float(b.float().abs().max())
    with pytest.raises(ValueError, match="multiple of the tiles"):
        ctf.tile_mxu(q[:, :, :200], k[:, :, :200], v[:, :, :200], s)


def test_measure_and_render_on_cpu():
    """All six variants run (their plain versions on the CPU) and give
    per-tile numbers; the render names each variant."""
    recs = measure(seq=SEQ, d=D, h=H, windows=1, device="cpu")
    assert {r["variant"] for r in recs} == {
        "full", "mxu", "softmax_ks1", "no_exp2", "no_max",
        "no_exp2_no_max"}
    assert all(r["per_tile_us"] > 0 for r in recs)
    by = {r["variant"]: r for r in recs}
    assert by["full"]["tiles"] == H * sum(range(1, SEQ // TILE + 1))
    assert by["mxu"]["tiles"] == H * (SEQ // TILE) ** 2
    assert all(r["device"] == "cpu" and r["power_limit"] is None
               for r in recs)
    text = render(recs)
    assert "mxu-only" in text and "exp2" in text and "rowmax" in text
    assert "shipped (flash_fwd causal)" in text.splitlines()[-1]


def test_cli_prints_jax_record_keys(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("XLA_FLAGS", None)
    out = tmp_path / "tf.jsonl"
    r = subprocess.run([sys.executable, "-m", "icikit_torch.bench.tile_floor",
                        "--device", "cpu", "--seq", "128", "--dhead", "64",
                        "--windows", "1", "--json", str(out)], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    recs = [json.loads(line) for line in r.stdout.strip().splitlines()]
    assert len(recs) == 6 and out.read_text().count("\n") == 6
    assert {"kind", "variant", "seq", "d", "bq", "bk", "tiles", "median_s",
            "spread_s", "per_tile_us", "session_quality", "device",
            "power_limit"} <= set(recs[0])
    assert "shipped" in r.stderr
