"""The port's threefry and sampled decode against JAX's, on the CPU.

``utils/threefry.py`` reproduces ``jax.random``'s key data, bits and
uniforms bit for bit; its Gumbel draws go through torch's ``log``, so
they sit within 1e-6 of JAX's (an ulp at the largest draws, ~16) and a
categorical draw may differ from JAX's only where the row's top two
(Gumbel + logits) values lie within that: each such mismatch must show
a top-2 gap below NEAR_TIE, and the tests report the count.
``sample_generate`` is held to JAX's at each mesh with the same key
data and seeds, tokens bitwise equal except after such a near-tie,
which the test checks on the port's draw at the first differing step
(where both rows hold the same prefix, so the same logits but for
float32 rounding).
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
from icikit.models.transformer import decode as jd
from icikit.models.transformer.model import make_model_mesh as j_mesh
from icikit_torch.interop import params_from_jax
from icikit_torch.models.transformer import (TransformerConfig,
                                             greedy_generate,
                                             make_model_mesh,
                                             sample_generate)
from icikit_torch.models.transformer import decode as td
from icikit_torch.utils import threefry as tf

NEAR_TIE = 1e-5
CFG = dict(vocab=64, d_model=32, n_heads=4, d_head=8, d_ff=64, n_layers=2,
           max_seq=64, compute_dtype="float32", pos_encoding="rope")
SEEDS = np.array([0, 1, 7, -1, -7, 2**31 - 1, -2**31], np.int32)


def _jkey(seed):
    return jax.random.key(seed)


def _kd(key):
    return np.asarray(jax.random.key_data(key))


# ------------------------------------------------------------- threefry


@pytest.mark.parametrize("seed", [0, 1, 5, -1, 2**31 - 1, 2**32 + 5])
def test_key_data_and_fold_in_bitwise(seed):
    assert (tf.to_numpy(tf.key_data(seed)) == _kd(_jkey(seed))).all()
    key = _jkey(seed)
    want = np.asarray(jax.vmap(lambda s: jax.random.key_data(
        jax.random.fold_in(key, s)))(jnp.asarray(SEEDS)))
    got = tf.fold_in(tf.as_key_data(_kd(key)), torch.from_numpy(SEEDS))
    np.testing.assert_array_equal(tf.to_numpy(got), want)


def test_fold_streams_and_positions_bitwise():
    key = _jkey(11)
    streams_j = jd.fold_streams(jax.random.key_data(key), jnp.asarray(SEEDS))
    streams_t = td.fold_streams(_kd(key), torch.from_numpy(SEEDS))
    np.testing.assert_array_equal(tf.to_numpy(streams_t),
                                  np.asarray(jax.random.key_data(streams_j)))
    pos1 = np.arange(len(SEEDS), dtype=np.int32) * 37
    pos2 = (np.arange(len(SEEDS) * 3, dtype=np.int32) * 5).reshape(-1, 3)
    for pos in (pos1, pos2):
        want = jax.random.key_data(jd.fold_positions(streams_j,
                                                     jnp.asarray(pos)))
        got = td.fold_positions(streams_t, torch.from_numpy(pos))
        np.testing.assert_array_equal(tf.to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 3, 2**32 - 1])
def test_request_stream_data_equals_jax(seed):
    np.testing.assert_array_equal(td.request_stream_data(seed),
                                  jd.request_stream_data(seed))
    assert td.request_stream_data(seed).dtype == np.uint32
    with pytest.raises(OverflowError):
        td.request_stream_data(-1)


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 1000), (4096,)])
def test_random_bits_and_uniform_bitwise(shape):
    key = jax.random.fold_in(_jkey(3), 9)
    t = tf.as_key_data(_kd(key))
    np.testing.assert_array_equal(
        tf.to_numpy(tf.random_bits(t, shape)),
        np.asarray(jax.random.bits(key, shape)))
    np.testing.assert_array_equal(
        tf.uniform(t, shape).numpy(), np.asarray(jax.random.uniform(
            key, shape)))
    tiny = float(np.finfo(np.float32).tiny)
    np.testing.assert_array_equal(
        tf.uniform(t, shape, tiny, 1.0).numpy(),
        np.asarray(jax.random.uniform(key, shape, minval=tiny,
                                      maxval=1.0)))
    # a scaled range: XLA contracts ``u * (max - min) + min`` into one
    # FMA in its vectorised loops (at these shapes, not at 1 or 7), one
    # rounding where torch rounds twice: within an ulp at |x| < 4
    np.testing.assert_allclose(
        tf.uniform(t, shape, -2.0, 3.0).numpy(),
        np.asarray(jax.random.uniform(key, shape, minval=-2.0,
                                      maxval=3.0)), rtol=0, atol=2**-22)


def test_batched_keys_bits_bitwise():
    """A (b, 2) key batch draws each row's bits as its own key does."""
    keys = jax.vmap(lambda s: jax.random.fold_in(_jkey(1), s))(
        jnp.arange(5))
    want = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (33,)))(keys))
    got = tf.random_bits(tf.as_key_data(np.asarray(
        jax.random.key_data(keys))), (33,))
    np.testing.assert_array_equal(tf.to_numpy(got), want)


def test_gumbel_within_1e6():
    keys = jax.vmap(lambda s: jax.random.fold_in(_jkey(2), s))(
        jnp.arange(32))
    want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (4096,)))(
        keys))
    got = tf.gumbel(tf.as_key_data(np.asarray(jax.random.key_data(keys))),
                    (4096,)).numpy()
    assert np.abs(got - want).max() <= 1e-6


def _top2_gap(v):
    s = np.sort(v)[::-1]
    return float(s[0] - s[1])


def _draw_mismatches(keys, lg, want, got):
    """The rows where two draws differ, each with the top-2 gap of JAX's
    Gumbel draws plus its logits."""
    g = np.asarray(jax.vmap(lambda k: jax.random.gumbel(
        k, (lg.shape[-1],)))(keys))
    return [(r, _top2_gap(g[r] + lg[r])) for r in np.flatnonzero(want != got)]


def test_categorical_equals_jax_up_to_near_ties():
    rng = np.random.default_rng(0)
    keys = jax.vmap(lambda s: jax.random.fold_in(_jkey(4), s))(
        jnp.arange(128))
    kd = tf.as_key_data(np.asarray(jax.random.key_data(keys)))
    bad, total = [], 0
    for scale in (1.0, 0.01):
        lg = (rng.standard_normal((128, 4096)) * scale).astype(np.float32)
        want = np.asarray(jax.vmap(jax.random.categorical)(keys,
                                                           jnp.asarray(lg)))
        got = tf.categorical(kd, torch.from_numpy(lg)).numpy()
        mism = _draw_mismatches(keys, lg, want, got)
        total += len(mism)
        bad += [m for m in mism if m[1] >= NEAR_TIE]
    print(f"categorical: {total} of 256 draws differ, all near-ties")
    assert bad == []


# ------------------------------------------------------------ the filter


def _knob_grid(v):
    return [(t, k, p) for t in (0.5, 1.0) for k in (0, 1, 7, v)
            for p in (1.0, 0.9, 0.3)]


def _nucleus_rounding(lg, t, k, p):
    """The entries whose nucleus decision sits within float32 rounding:
    at the entry's place in JAX's descending sort, JAX's ``cum - probs``
    lies within NUCLEUS_EPS of ``top_p``. XLA's softmax and cumsum add
    in other orders than torch's, so there the two may decide apart
    (``top_p = 1`` with top-k on: the tail whose cumulative sum rounds
    to 1)."""
    x = jnp.asarray(lg) / max(t, 1e-6)
    srt = jnp.sort(x, axis=-1)[..., ::-1]
    thr_k = srt[..., k - 1:k] if k > 0 else -jnp.inf
    srt2 = jnp.where(srt < thr_k, -jnp.inf, srt)
    probs = jax.nn.softmax(srt2, axis=-1)
    cum = jnp.cumsum(probs, axis=-1)
    near = np.abs(np.asarray(cum - probs) - p) <= NUCLEUS_EPS
    srt, x = np.asarray(srt), np.asarray(x)
    return np.stack([np.isin(x[r], srt[r][near[r]])
                     for r in range(x.shape[0])])


NUCLEUS_EPS = 1e-6


def test_sample_filter_matches_jax_over_the_knob_grid():
    v = 61
    rng = np.random.default_rng(1)
    lg = (rng.standard_normal((6, v)) * 2).astype(np.float32)
    lg[0, :5] = lg[0, 5]         # ties at the top-k threshold
    rounding = 0
    for t, k, p in _knob_grid(v):
        want = np.asarray(jax.vmap(lambda row: jd._sample_filter(
            row, jnp.float32(t), jnp.float32(k), jnp.float32(p)))(
            jnp.asarray(lg)))
        knob = lambda x: torch.full((6,), x, dtype=torch.float32)
        got = td._sample_filter(torch.from_numpy(lg), knob(t), knob(k),
                                knob(p)).numpy()
        apart = np.isneginf(got) != np.isneginf(want)
        assert not (apart & ~_nucleus_rounding(lg, t, k, p)).any(), (t, k, p)
        rounding += int(apart.sum())
        fin = np.isfinite(want) & np.isfinite(got)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=0,
                                   err_msg=f"{(t, k, p)}")
        if k == 0 and p == 1.0:   # the neutral knobs bypass bitwise
            np.testing.assert_array_equal(got, lg / np.float32(t))
    print(f"_sample_filter: {rounding} entries decided apart, each within "
          "float32 rounding of top_p")


def test_select_tokens_equal_jax_up_to_near_ties():
    """``select_tokens`` at shared and per-row knobs, (b, V) and
    (b, k, V), with and without the filters."""
    rng = np.random.default_rng(2)
    b, k, v = 16, 3, 64
    lg2 = rng.standard_normal((b, v)).astype(np.float32)
    lg3 = rng.standard_normal((b, k, v)).astype(np.float32)
    keys2 = jax.vmap(lambda s: jax.random.fold_in(_jkey(6), s))(
        jnp.arange(b))
    keys3 = jax.vmap(lambda s: jax.vmap(lambda q: jax.random.fold_in(
        jax.random.fold_in(_jkey(6), s), q))(jnp.arange(k)))(jnp.arange(b))
    shared = np.array([0.8, 0.9, 40.0], np.float32)
    per_row = np.stack([rng.uniform(0.3, 1.5, b), rng.uniform(0.2, 1.0, b),
                        rng.integers(0, v, b)], 1).astype(np.float32)
    per_row[0, 0] = 0.0          # a greedy row among sampled ones
    total = 0
    for lg, keys in ((lg2, keys2), (lg3, keys3)):
        kd = tf.as_key_data(np.asarray(jax.random.key_data(keys)))
        for knobs in (shared, per_row):
            for filters in (True, False):
                want = np.asarray(jd.select_tokens(
                    jnp.asarray(lg), keys, jnp.asarray(knobs), filters))
                got = td.select_tokens(torch.from_numpy(lg), kd,
                                       torch.from_numpy(knobs),
                                       filters).numpy()
                assert got.dtype == np.int32
                diff = np.argwhere(want != got)
                total += len(diff)
                for idx in diff:
                    row = tuple(idx)
                    kn = knobs if knobs.ndim == 1 else knobs[row[0]]
                    x = np.asarray(jd._sample_filter(
                        jnp.asarray(lg[row]), jnp.float32(kn[0]),
                        jnp.float32(kn[2]), jnp.float32(kn[1]))
                        if filters else jnp.asarray(lg[row]) / kn[0])
                    g = np.asarray(jax.random.gumbel(keys[row], (v,)))
                    assert _top2_gap(g + x) < NEAR_TIE, row
    print(f"select_tokens: {total} draws differ, all near-ties")
    # temperature 0 is the raw argmax, bitwise
    kd = tf.as_key_data(np.asarray(jax.random.key_data(keys2)))
    zero = torch.tensor([0.0, 0.5, 3.0])
    np.testing.assert_array_equal(
        td.select_tokens(torch.from_numpy(lg2), kd, zero).numpy(),
        lg2.argmax(-1))


@pytest.mark.parametrize("temperature,top_k,top_p,match", [
    (-0.1, 0, 1.0, "temperature"), (1.0, 0, 0.0, "top_p"),
    (1.0, 0, 1.5, "top_p"), (1.0, -1, 1.0, "top_k"),
    (1.0, 65, 1.0, "top_k")])
def test_sampling_args_refused_as_jax(temperature, top_k, top_p, match):
    jcfg, tcfg = JConfig(**CFG), TransformerConfig(**CFG)
    with pytest.raises(ValueError, match=match) as je:
        jd._check_sampling_args(jcfg, temperature, top_k, top_p)
    with pytest.raises(ValueError, match=match) as te:
        td._check_sampling_args(tcfg, temperature, top_k, top_p)
    assert str(te.value) == str(je.value)


# ------------------------------------------------------ sample_generate


def _setup(cfg: dict, dp: int, tp: int, batch: int = 4, s: int = 6,
           seed: int = 0):
    mesh = j_mesh(dp=dp, tp=tp, sp=1)
    jparams = j_init_params(jax.random.key(seed),
                            JConfig(**dict(cfg, decode_quant="none")), mesh)
    prompt = np.random.default_rng(seed + 2).integers(
        0, cfg["vocab"], (batch, s)).astype(np.int32)
    pd = jax.device_put(jnp.asarray(prompt),
                        NamedSharding(mesh, P("dp", None)))
    tparams = params_from_jax({k: np.asarray(v) for k, v in jparams.items()},
                              "cpu")
    return mesh, jparams, pd, tparams, prompt


def _draw_gap(lg, key, seed: int, pos: int, knobs: dict) -> float:
    """The top-2 gap of the port's draw of the token at ``pos`` from
    logits ``lg (V,)``."""
    draw_key = td.fold_positions(td.fold_streams(key, [seed]), [pos])
    return float(td.draw_gap(lg[None], draw_key, [
        knobs["temperature"], knobs["top_p"], knobs["top_k"]])[0])


KNOBS = dict(temperature=0.8, top_k=40, top_p=0.9)


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("dp,tp", [(1, 1), (2, 1), (2, 2), (1, 4)])
def test_sample_generate_equals_jax_up_to_near_ties(dp, tp, quant):
    cfg = dict(CFG, decode_quant=quant, quant_matvec="xla",
               vocab_parallel=tp == 4)
    mesh, jparams, pd, tparams, prompt = _setup(cfg, dp, tp, seed=dp + tp)
    jcfg = JConfig(**cfg, decode_step="unfused")
    key = jax.random.key(1)
    seeds = np.array([3, 9, -5, 2**31 - 1], np.int32)
    want = np.asarray(jd.sample_generate(jparams, pd, mesh, jcfg, 8, key,
                                         **KNOBS, seeds=seeds))
    got, lg = sample_generate(
        tparams, torch.from_numpy(prompt),
        make_model_mesh(dp=dp, tp=tp, device="cpu"), TransformerConfig(**cfg),
        8, _kd(key), **KNOBS, seeds=seeds, return_logits=True)
    got = got.numpy()
    s = prompt.shape[1]
    diverged = 0
    for r in range(got.shape[0]):
        diff = np.flatnonzero(got[r, s:] != want[r, s:])
        if diff.size:
            # the first differing draw: the same prefix in both, so the
            # same logits but for float32 rounding
            diverged += 1
            j = int(diff[0])
            gap = _draw_gap(lg[j, r], _kd(key), int(seeds[r]), s + j, KNOBS)
            assert gap < NEAR_TIE, (r, j, gap)
    print(f"sample_generate at ({dp}, {tp}) {quant}: {diverged} of "
          f"{got.shape[0]} rows diverged, each after a near-tie")


def test_temperature_zero_is_greedy_and_top_k_one_is_greedy():
    cfg = TransformerConfig(**CFG)
    _, _, _, tparams, prompt = _setup(CFG, 1, 1)
    mesh = make_model_mesh(dp=2, tp=2, device="cpu")
    p = torch.from_numpy(prompt)
    base = greedy_generate(tparams, p, mesh, cfg, 10)
    key = tf.to_numpy(tf.key_data(9))
    np.testing.assert_array_equal(
        sample_generate(tparams, p, mesh, cfg, 10, key,
                        temperature=0.0).numpy(), base.numpy())
    np.testing.assert_array_equal(
        sample_generate(tparams, p, mesh, cfg, 10, key, temperature=1.3,
                        top_k=1).numpy(), base.numpy())


def test_sample_invariant_to_batch_composition():
    """JAX's test: row r of a batch equals the same (prompt, seed)
    sampled alone or in another co-batch."""
    cfg = TransformerConfig(**CFG)
    _, _, _, tparams, _ = _setup(CFG, 1, 1)
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, CFG["vocab"], (3, 7)).astype(np.int32))
    mesh = make_model_mesh(device="cpu")
    key = tf.to_numpy(tf.key_data(5))

    def run(p, seeds):
        return sample_generate(tparams, p, mesh, cfg, 9, key,
                               temperature=1.1, top_p=0.9, seeds=seeds)

    batch = run(prompts, [3, 9, 5])
    np.testing.assert_array_equal(batch[1].numpy(),
                                  run(prompts[1:2], [9])[0].numpy())
    np.testing.assert_array_equal(batch[1].numpy(),
                                  run(prompts[1:], [9, 5])[0].numpy())


def test_sample_seeds_differentiate_identical_prompts():
    cfg = TransformerConfig(**CFG)
    _, _, _, tparams, _ = _setup(CFG, 1, 1)
    p = torch.arange(6, dtype=torch.int32).expand(2, 6).contiguous()
    mesh = make_model_mesh(device="cpu")
    key = tf.to_numpy(tf.key_data(0))
    out = sample_generate(tparams, p, mesh, cfg, 10, key, temperature=2.0,
                          seeds=[0, 1])
    assert not torch.equal(out[0], out[1])
    again = sample_generate(tparams, p, mesh, cfg, 10, key, temperature=2.0,
                            seeds=[0, 1])
    np.testing.assert_array_equal(out.numpy(), again.numpy())
    # the default seeds are arange(B); key data may be a tensor
    np.testing.assert_array_equal(
        sample_generate(tparams, p, mesh, cfg, 10,
                        torch.tensor([0, 0], dtype=torch.int64),
                        temperature=2.0).numpy(), out.numpy())


@pytest.mark.parametrize("steps_a_chunk", [1, 3])
def test_sample_noise_chunks_do_not_change_the_draws(monkeypatch,
                                                     steps_a_chunk):
    """A generate makes its draws' Gumbel noise a chunk of steps at a
    time; a chunk of 1 or 3 steps (a last chunk cut short) gives the
    tokens of one chunk for every step."""
    cfg = TransformerConfig(**CFG)
    _, _, _, tparams, prompt = _setup(CFG, 1, 1)
    p = torch.from_numpy(prompt)
    mesh = make_model_mesh(dp=2, tp=2, device="cpu")
    key = tf.to_numpy(tf.key_data(4))

    def run():
        return sample_generate(tparams, p, mesh, cfg, 8, key, **KNOBS)

    whole = run()
    monkeypatch.setattr(td, "NOISE_CHUNK_ELEMS",
                        steps_a_chunk * p.shape[0] * CFG["vocab"])
    np.testing.assert_array_equal(run().numpy(), whole.numpy())


def test_sample_generate_prefill_die_site():
    from icikit_torch import chaos
    cfg = TransformerConfig(**CFG)
    _, _, _, tparams, prompt = _setup(CFG, 1, 1)
    plan = chaos.FaultPlan(schedule={"die:decode.prefill": (0,)})
    mesh = make_model_mesh(device="cpu")
    with chaos.inject(plan):
        with pytest.raises(chaos.InjectedDeath):
            sample_generate(tparams, torch.from_numpy(prompt), mesh, cfg, 3,
                            tf.to_numpy(tf.key_data(0)))
        out = sample_generate(tparams, torch.from_numpy(prompt), mesh, cfg,
                              3, tf.to_numpy(tf.key_data(0)))
    assert out.shape == (4, 9)
    assert plan.fired("die", "decode.prefill") == 1
