"""The port's load-balancing study against the JAX package's, on the CPU.

The same boards (numpy generators, the same seeds) go through
``icikit.models.solitaire`` and ``icikit_torch.models.solitaire``: the
port's plain ``solve_batch`` (the DFS kernel's oracle) equals JAX's
``solve_batch`` bit for bit on all five outputs; the generators give the
same boards; the schedulers with 8 CPU workers give JAX's results on its
8-device mesh; a checkpoint written by either package resumes in the
other; ``simulate_schedule`` agrees. Budgets stay small: the plain
solver steps the batch from the host (~0.2 ms a step here).
"""

from __future__ import annotations

import json
import warnings

import numpy as np
import pytest
import torch

import jax

from icikit.models.solitaire import dataset as jds
from icikit.models.solitaire import game as jgame
from icikit.models.solitaire import scheduler as jsched
from icikit_torch import chaos
from icikit_torch.models.solitaire import dataset as tds
from icikit_torch.models.solitaire import game as tgame
from icikit_torch.models.solitaire import scheduler as tsched

CPU8 = ["cpu"] * 8
EDGES = ("1" + "0" * 24, "0" * 25, "1" * 25, "111" + "0" * 22,
         "110" + "0" * 22, "11000" * 2 + "0" * 15, "112" + "0" * 22)


def _jax_outputs(pegs, playable, max_steps):
    return [np.asarray(x) for x in jgame.solve_batch(pegs, playable,
                                                     max_steps)]


def _assert_same(jax_out, port_out):
    for a, b in zip(jax_out, port_out):
        b = b.numpy() if isinstance(b, torch.Tensor) else b
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the plain solver against JAX's solve_batch


@pytest.mark.parametrize("grade,n,seed,max_steps", [
    ("easy", 48, 7, 2_000_000_000),
    ("medium", 32, 7, 3000),
    ("hard", 6, 0, 2000),
])
def test_plain_solve_batch_matches_jax(grade, n, seed, max_steps):
    ds = jds.generate_dataset(n, grade, seed=seed)
    _assert_same(_jax_outputs(ds.pegs, ds.playable, max_steps),
                 tgame.solve_batch(ds.pegs, ds.playable, max_steps,
                                   device="cpu"))


@pytest.mark.parametrize("max_steps", [0, 1, 3, 2_000_000_000])
def test_plain_solve_batch_edge_boards_match_jax(max_steps):
    b = tgame.BoardBatch.from_strings(list(EDGES))
    out = tgame.solve_batch(torch.from_numpy(b.pegs.view(np.int32)),
                            torch.from_numpy(b.playable.view(np.int32)),
                            max_steps)
    _assert_same(_jax_outputs(b.pegs, b.playable, max_steps), out)
    if max_steps > 3:
        solved, n_moves, moves = (x.numpy() for x in out[:3])
        assert solved.tolist() == [True, False, False, False, True, True,
                                   False]
        # the domino's one move, the square's three, replayed
        assert moves[4, 0] == 2 * 4 + 3 and n_moves[5] == 3
        final = tgame.replay_moves(*tgame.parse_board(EDGES[5]),
                                   moves[5, :3])[-1]
        assert bin(final).count("1") == 1


def test_plain_solve_batch_takes_any_mask_bits():
    """uint32 masks with bits past the 25 cells, as uint32, int32 and
    int64 tensors: JAX's rules for every bit."""
    rng = np.random.default_rng(1)
    pegs = rng.integers(0, 2**32, 40, dtype=np.uint64).astype(np.uint32)
    play = rng.integers(0, 2**32, 40, dtype=np.uint64).astype(np.uint32)
    pegs[20:] &= play[20:] & 0x1FFFFFF
    want = _jax_outputs(pegs, play, 400)
    for conv in (lambda a: torch.from_numpy(a.view(np.int32)),
                 lambda a: torch.from_numpy(a.view(np.int32)).view(
                     torch.uint32),
                 lambda a: torch.from_numpy(a.astype(np.int64))):
        _assert_same(want, tgame.solve_batch(conv(pegs), conv(play), 400))


def test_solve_batch_refuses_a_budget_past_int32():
    b = tgame.BoardBatch.from_strings(list(EDGES[:2]))
    with pytest.raises(ValueError, match="int32"):
        tgame.solve_batch(b.pegs, b.playable, 2**31, device="cpu")
    with pytest.raises(ValueError, match="1-d"):
        tgame.solve_batch(torch.zeros(2, 2, dtype=torch.int64),
                          torch.zeros(2, 2, dtype=torch.int64))


def test_board_helpers_match_jax():
    s = "2111210112221122212222222"
    assert tgame.parse_board(s) == jgame.parse_board(s)
    p, q = tgame.parse_board(s)
    assert tgame.render_board(p, q) == s
    assert tgame.pretty_board(p, q) == jgame.pretty_board(p, q)
    board = "11000" * 2 + "0" * 15
    ok, moves, nodes = tgame.solve_one_py(*tgame.parse_board(board))
    assert (ok, moves, nodes) == jgame.solve_one_py(*jgame.parse_board(board))
    assert tgame.render_solution(board, moves) == \
        jgame.render_solution(board, moves)
    with pytest.raises(ValueError):
        tgame.replay_moves(*tgame.parse_board("0110" + "0" * 21), [0])


# ---------------------------------------------------------------------------
# generators and the on-disk format


@pytest.mark.parametrize("grade", sorted(jds.GRADES))
@pytest.mark.parametrize("seed,frac", [(0, 0.7), (5, 0.0), (11, 1.0)])
def test_generators_match_jax_bit_for_bit(grade, seed, frac):
    a = jds.generate_dataset(120, grade, seed=seed, solvable_fraction=frac)
    b = tds.generate_dataset(120, grade, seed=seed, solvable_fraction=frac)
    assert b.pegs.dtype == np.uint32 and b.playable.dtype == np.uint32
    np.testing.assert_array_equal(a.pegs, b.pegs)
    np.testing.assert_array_equal(a.playable, b.playable)


def test_skewed_generator_matches_jax():
    a = jds.generate_skewed_dataset(256, seed=3, hard_fraction=0.25)
    b = tds.generate_skewed_dataset(256, seed=3, hard_fraction=0.25)
    np.testing.assert_array_equal(a.pegs, b.pegs)
    np.testing.assert_array_equal(a.playable, b.playable)
    assert tds.GRADES == jds.GRADES
    with pytest.raises(ValueError):
        tds.generate_dataset(4, "impossible")


@pytest.mark.parametrize("name", ["games.dat", "games.dat.gz"])
def test_dataset_round_trip_across_packages(tmp_path, name):
    ds = tds.generate_dataset(20, "medium", seed=4)
    path = str(tmp_path / name)
    tds.save_dataset(path, ds)
    for load in (tds.load_dataset, jds.load_dataset):
        back = load(path)
        np.testing.assert_array_equal(back.pegs, ds.pegs)
        np.testing.assert_array_equal(back.playable, ds.playable)
    jpath = str(tmp_path / ("j" + name))
    jds.save_dataset(jpath, ds)
    assert open(jpath, "rb").read() == open(path, "rb").read() \
        or name.endswith(".gz")
    np.testing.assert_array_equal(tds.load_dataset(jpath).pegs, ds.pegs)


def test_dataset_bad_header(tmp_path):
    p = tmp_path / "bad.dat"
    p.write_text("5\n" + "1" * 25 + "\n")
    with pytest.raises(ValueError, match="bad.dat"):
        tds.load_dataset(p)


# ---------------------------------------------------------------------------
# the schedulers: 8 CPU workers against JAX's 8-device mesh


def _assert_reports_equal(j, t):
    for k in ("solved", "n_moves", "moves", "steps", "status"):
        a, b = getattr(j, k), getattr(t, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b)
    assert j.n_solutions == t.n_solutions


def test_schedulers_with_8_workers_match_jax():
    assert len(jax.devices()) == 8
    ds = tds.generate_dataset(64, "easy", seed=9)
    ms = 400
    jst = jsched.solve_static(ds, max_steps=ms)
    tst = tsched.solve_static(ds, devices=CPU8, max_steps=ms)
    _assert_reports_equal(jst, tst)
    assert tst.per_worker_games == jst.per_worker_games == [8] * 8
    assert tst.per_worker_steps == jst.per_worker_steps
    assert tst.imbalance == jst.imbalance
    jdy = jsched.solve_dynamic(ds, chunk_size=4, max_steps=ms)
    tdy = tsched.solve_dynamic(ds, devices=CPU8, chunk_size=4, max_steps=ms)
    _assert_reports_equal(jdy, tdy)
    _assert_reports_equal(jst, tdy)
    assert sum(tdy.per_worker_games) == 64
    assert sum(tdy.per_worker_steps) == sum(jdy.per_worker_steps)
    assert len(tdy.per_worker_steps) == 8 and tdy.n_pulls >= 1


def test_dynamic_chunk_accounting_padding_and_empty():
    ds = tds.generate_dataset(50, "easy", seed=10)   # 6 x 8 + 2: ragged
    rep = tsched.solve_dynamic(ds, devices=CPU8[:3], chunk_size=8,
                               max_steps=300)
    assert sum(rep.per_worker_games) == 50 and len(rep.solved) == 50
    st = tsched.solve_static(ds, devices=CPU8[:3], max_steps=300)
    assert rep.n_solutions == st.n_solutions
    assert st.per_worker_games == [17, 17, 16]
    # 9 solvable games in chunks of 8: 7 padding boards never count
    ds9 = tds.generate_dataset(9, "easy", seed=12, solvable_fraction=1.0)
    assert tsched.solve_dynamic(ds9, devices=CPU8[:2], chunk_size=8,
                                max_steps=5000).n_solutions == 9
    empty = tsched.solve_dynamic(tds.generate_dataset(0, "easy"),
                                 devices=CPU8)
    assert empty.n_solutions == 0 and empty.moves.shape == (0, 25)


def test_default_worker_is_one_on_the_card():
    assert tsched._workers(None) == [torch.device("cuda")]
    assert tsched._workers(["cpu", "cpu"]) == [torch.device("cpu")] * 2


def test_write_solutions_renders_replayable(tmp_path):
    ds = tds.generate_dataset(12, "easy", seed=13, solvable_fraction=1.0)
    rep = tsched.solve_static(ds, devices=CPU8[:2])
    out = tmp_path / "solutions.txt"
    assert tsched.write_solutions(out, ds, rep) == 12
    jout = tmp_path / "jax.txt"
    jsched.write_solutions(jout, ds, rep)
    assert out.read_text() == jout.read_text()


# ---------------------------------------------------------------------------
# checkpoints: one format, either package resumes the other's


def _marker(full, n=8):
    return tuple(np.asarray(a) for a in (
        full.solved[:n], full.n_moves[:n], full.moves[:n],
        np.full(n, 999_999, np.int32), full.status[:n]))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_across_packages(tmp_path, writer):
    ds = tds.generate_dataset(32, "easy", seed=21)
    ms = 2000
    fp = tsched.checkpoint_fingerprint(ds, 8, ms)
    assert fp == jsched.checkpoint_fingerprint(ds, 8, ms)
    full = tsched.solve_static(ds, devices=CPU8[:2], max_steps=ms)
    ck = str(tmp_path / "run.ckpt")
    # a record of chunk 0 with a marker no solve produces: the resumed
    # run must carry it through, so chunk 0 was loaded, not re-solved
    store = (jsched if writer == "jax" else tsched).ChunkCheckpoint(ck, fp)
    store.add(0, _marker(full))
    if writer == "jax":
        resumed = tsched.solve_dynamic(ds, devices=CPU8[:2], chunk_size=8,
                                       max_steps=ms, checkpoint_path=ck)
    else:
        resumed = jsched.solve_dynamic(ds, chunk_size=8, max_steps=ms,
                                       checkpoint_path=ck)
    assert (resumed.steps[:8] == 999_999).all()
    np.testing.assert_array_equal(resumed.solved, full.solved)
    np.testing.assert_array_equal(resumed.steps[8:], full.steps[8:])
    # the chunks the resumed run solved went into the same file; the
    # other package loads all four
    other = (tsched if writer == "jax" else jsched).ChunkCheckpoint(
        ck, fp, chunk_size=8)
    assert sorted(other.loaded) == [0, 1, 2, 3]


def test_checkpoint_refuses_other_work_and_skips_bad_records(tmp_path):
    ds = tds.generate_dataset(16, "easy", seed=9)
    ck = tmp_path / "c.ckpt"
    full = tsched.solve_dynamic(ds, devices=CPU8[:2], chunk_size=8,
                                max_steps=2000, checkpoint_path=str(ck))
    with pytest.raises(ValueError, match="different dataset"):
        tsched.solve_dynamic(ds, devices=CPU8[:2], chunk_size=4,
                             max_steps=2000, checkpoint_path=str(ck))
    good = json.loads(open(ck).readlines()[1])
    with open(ck, "a") as f:
        for rec in (dict(good, solved=good["solved"][:-1]),
                    dict(good, chunk="one"), dict(good, steps=None)):
            f.write(json.dumps(rec) + "\n")
        f.write('{"chunk": 1, "solved": [tru')   # a torn tail
    fp = tsched.checkpoint_fingerprint(ds, 8, 2000)
    assert tsched.ChunkCheckpoint(str(ck), fp, chunk_size=8).n_skipped == 3
    resumed = tsched.solve_dynamic(ds, devices=CPU8[:2], chunk_size=8,
                                   max_steps=2000, checkpoint_path=str(ck))
    np.testing.assert_array_equal(resumed.steps, full.steps)
    store = tsched.ChunkCheckpoint(str(tmp_path / "s.ckpt"), "fp",
                                   chunk_size=8)
    store.close()
    store.add(0, _marker(full))       # a straggler's write: dropped
    assert not tsched.ChunkCheckpoint(str(tmp_path / "s.ckpt"), "fp",
                                      chunk_size=8).loaded


# ---------------------------------------------------------------------------
# the virtual clock and the lease queue


@pytest.mark.parametrize("p", [1, 3, 8])
def test_simulate_schedule_matches_jax(p):
    steps = np.random.default_rng(p).integers(1, 10**6, 203)
    for strategy, kw in (("static", {}), ("dynamic", {}),
                         ("dynamic", {"chunk_size": 3, "max_pull": 5})):
        assert tsched.simulate_schedule(steps, p, strategy, **kw) == \
            jsched.simulate_schedule(steps, p, strategy, **kw)
    with pytest.raises(ValueError):
        tsched.simulate_schedule(steps, p, "random")


def _queue(chunks, lease_s=60.0, workers=2):
    return tsched._LeaseQueue(list(range(chunks)), lease_s, workers)


def test_lease_queue_death_reissues_inflight_chunks():
    q = _queue(4)
    mine = q.claim(0, p=2, max_pull=2)
    q.mark_dead(0, RuntimeError("boom"))
    assert q.reissues == len(mine)
    seen = []
    while True:
        got = q.claim(1, p=2, max_pull=4)
        if not got:
            break
        for c in got:
            assert q.commit(1, c, games=1, steps=1)
        seen += got
    assert sorted(seen) == [0, 1, 2, 3] and q.deaths.keys() == {0}


def test_lease_queue_expiry_and_late_commit():
    q = _queue(2, lease_s=0.0)
    assert q.claim(0, p=2, max_pull=1) == [0]
    got = []
    while len(got) < 2:
        pulled = q.claim(1, p=2, max_pull=1)
        got += pulled
        assert q.commit(1, pulled[0], games=1, steps=1)
    assert sorted(got) == [0, 1] and q.reissues >= 1
    assert q.commit(0, 0, games=1, steps=1) is False
    assert q.per_games[0] == 0 and q.claim(0, p=2, max_pull=1) == []


def test_lease_queue_no_survivors_raises_promptly():
    q = _queue(4)
    q.claim(0, p=2, max_pull=1)
    q.mark_dead(0, RuntimeError("first"))
    q.mark_dead(1, ValueError("second"))
    with pytest.raises(tsched.NoSurvivorsError) as ei:
        q.wait_drained()
    assert ei.value.deaths.keys() == {0, 1}
    assert "2 workers died" in str(ei.value)


# ---------------------------------------------------------------------------
# drills


def test_dynamic_drill_heals_and_matches_the_clean_run():
    ds = tds.generate_dataset(16, "easy", seed=5)
    clean = tsched.solve_dynamic(ds, devices=CPU8[:2], chunk_size=4,
                                 max_steps=1000)
    plan = chaos.FaultPlan(schedule={"die:solitaire.worker.1": (0,)})
    with chaos.inject(plan), pytest.warns(RuntimeWarning, match="worker 1"):
        rep = tsched.solve_dynamic(ds, devices=CPU8[:2], chunk_size=4,
                                   max_steps=1000)
    assert rep.n_deaths == 1 and rep.worker_deaths == [1]
    assert "InjectedDeath" in rep.death_errors[0]
    assert rep.per_worker_games == [16, 0]
    for k in ("solved", "n_moves", "moves", "steps", "status"):
        np.testing.assert_array_equal(getattr(rep, k), getattr(clean, k))


def test_all_workers_dead_raises_with_telemetry():
    ds = tds.generate_dataset(16, "easy", seed=3)
    plan = chaos.FaultPlan(schedule={
        f"die:solitaire.worker.{w}": (0,) for w in range(2)})
    with chaos.inject(plan), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(tsched.NoSurvivorsError) as ei:
            tsched.solve_dynamic(ds, devices=CPU8[:2], chunk_size=4)
    assert sorted(ei.value.deaths) == [0, 1]
    assert all(isinstance(e, chaos.InjectedDeath)
               for e in ei.value.deaths.values())


def test_checkpoint_write_retries_transient_io_failures(tmp_path):
    ck = tmp_path / "flaky.ckpt"
    store = tsched.ChunkCheckpoint(str(ck), "fp", chunk_size=2)
    arrays = (np.zeros(2, bool), np.zeros(2, np.int32),
              np.full((2, 25), -1, np.int32), np.zeros(2, np.int32),
              np.zeros(2, np.int32))
    plan = chaos.FaultPlan(schedule={"io:solitaire.ckpt.write": (0, 1, 3)})
    with chaos.inject(plan):
        store.add(0, arrays)
        with pytest.raises(OSError):
            store.add(1, arrays, retries=0)
    assert plan.fired("io") == 3
    assert list(tsched.ChunkCheckpoint(str(ck), "fp",
                                       chunk_size=2).loaded) == [0]


# ---------------------------------------------------------------------------
# the CLI, the example and the north-star runner on the CPU


def test_run_cli_on_the_cpu(tmp_path, capsys):
    from icikit_torch.models.solitaire import run
    out, js = tmp_path / "sol.txt", tmp_path / "r.jsonl"
    assert run.main(["--device", "cpu", "--games", "24", "--strategy",
                     "all", "--max-steps", "300", "--output", str(out),
                     "--json", str(js)]) == 0
    recs = [json.loads(line) for line in open(js)]
    assert [r["strategy"] for r in recs] == ["static", "dynamic", "host"]
    assert len({r["n_solutions"] for r in recs}) == 1
    assert "found" in capsys.readouterr().out


def test_northstar_quick_on_the_cpu(tmp_path):
    from icikit_torch.bench import northstar
    from icikit_torch.utils.mesh import make_mesh
    coll, sorts, dlb, checks = northstar.run_northstar(
        make_mesh(8, device="cpu"), quick=True, runs=1, max_steps=200)
    assert checks["collectives_verified"] and checks["sorts_verified"]
    assert checks["dlb_schedulers_agree"]
    assert checks["dlb_dynamic_balances_skew"]
    assert {r.algorithm for r in sorts} == {
        "bitonic", "sample", "sample_bitonic", "quicksort"}
    assert {d["strategy"] for d in dlb} == {
        "static", "dynamic", "modeled-static", "modeled-dynamic"}
    meta = {"platform": "cpu", "p": 8, "date": "test", "wall_s": 0.0,
            "device": "cpu", "power_limit": None}
    md = northstar.render_markdown(coll, sorts, dlb, checks, meta)
    assert "Target checks" in md and "PASS" in md and "allreduce" in md
    # the records file re-renders without hardware
    import dataclasses
    path = tmp_path / "ns.jsonl"
    with open(path, "w") as f:
        for r in coll:
            f.write(json.dumps({"kind": "collective",
                                **dataclasses.asdict(r)}) + "\n")
        for r in sorts:
            f.write(json.dumps({"kind": "sort",
                                **dataclasses.asdict(r)}) + "\n")
        for d in dlb:
            f.write(json.dumps({"kind": "dlb", **d}) + "\n")
        f.write(json.dumps({"kind": "checks", **checks, **meta}) + "\n")
    assert northstar.regen_from_jsonl(str(path)) == md
