"""The port's native runtime (``icikit_torch.native``), built from its own
copy of the C++ sources: the parser, the DFS solver and its thread
pool, the corpus generator, the guard, and the lazy build under its own
lock, held against the port's plain solver and against ``icikit.native``
(both libraries loaded in this one process).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import icikit.native as jnative
from icikit.models.solitaire.dataset import generate_dataset
from icikit_torch import native
from icikit_torch.models.solitaire.game import solve_batch_plain, solve_one_py
from icikit_torch.models.solitaire.scheduler import solve_host

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, timeout=120,
                          cwd=ROOT, env=env)


def test_native_path_is_active_and_its_own():
    assert native.available(), native.build_error()
    assert native._LIB_PATH.endswith(
        os.path.join("icikit_torch", "native", "build",
                     "libicikit_torch.so"))
    assert os.path.exists(native.LOCK_PATH)      # the build's flock
    assert os.path.dirname(native.LOCK_PATH) == native.BUILD_DIR
    # the two packages' libraries load side by side
    assert jnative.available()
    assert os.path.realpath(native._LIB_PATH) != os.path.realpath(
        jnative._LIB_PATH)


def test_port_reads_nothing_of_the_jax_package():
    here = os.path.join(ROOT, "icikit_torch", "native")
    for name in os.listdir(os.path.join(here, "src")):
        assert os.path.isfile(os.path.join(here, "src", name))
    text = open(os.path.join(here, "__init__.py")).read() + \
        open(os.path.join(here, "Makefile")).read()
    assert "icikit/native/src" not in text.replace(
        "``icikit/native``'s", "")
    assert "libicikit.so" not in text


def test_parse_boards_matches_python_and_jax():
    ds = generate_dataset(40, "easy", seed=21)
    text = (f"{len(ds)}\n" + "\n".join(ds.to_strings()) + "\n").encode()
    pegs, playable = native.parse_boards(text)
    np.testing.assert_array_equal(pegs, ds.pegs)
    np.testing.assert_array_equal(playable, ds.playable)
    jp, jq = jnative.parse_boards(text)
    np.testing.assert_array_equal(pegs, jp)
    row = b"1" * 25
    assert len(native.parse_boards(b"  2 \r\n" + row + b"\r\n\n " + row)[0]) \
        == 2


def test_parse_boards_errors():
    with pytest.raises(ValueError, match="header"):
        native.parse_boards(b"x\n")
    with pytest.raises(ValueError, match="fewer rows"):
        native.parse_boards(b"3\n" + b"1" * 25 + b"\n")
    with pytest.raises(ValueError, match="row"):
        native.parse_boards(b"1\n111\n")


def test_native_solver_matches_jax_native_and_the_oracle():
    ds = generate_dataset(48, "medium", seed=31)
    port = native.solve_batch(ds.pegs, ds.playable, n_threads=4,
                              return_workers=True)
    ref = jnative.solve_batch(ds.pegs, ds.playable, n_threads=4)
    for a, b in zip(port[:4], ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert port[4].min() >= 0 and port[4].max() < 4
    ds = generate_dataset(24, "easy", seed=31)
    for i in range(len(ds)):
        ok, ms, nodes = solve_one_py(int(ds.pegs[i]), int(ds.playable[i]))
        nok, nms, nnodes = native.solve(int(ds.pegs[i]),
                                        int(ds.playable[i]))
        assert (ok, nodes) == (nok, nnodes) and (not ok or ms == nms)


@pytest.mark.parametrize("grade,max_steps", [("easy", 2000),
                                              ("medium", 1500)])
def test_native_solver_matches_the_plain_solver(grade, max_steps):
    """The card kernel's two references agree: the native host solver
    and the plain solver, on solved, n_moves, moves and steps."""
    ds = generate_dataset(40, grade, seed=2)
    solved, n_moves, moves, steps = native.solve_batch(
        ds.pegs, ds.playable, max_steps=max_steps, n_threads=2)
    plain = [t.numpy() for t in solve_batch_plain(ds.pegs, ds.playable,
                                                  max_steps)]
    np.testing.assert_array_equal(solved, plain[0])
    np.testing.assert_array_equal(n_moves, plain[1])
    np.testing.assert_array_equal(moves, plain[2])
    np.testing.assert_array_equal(steps, plain[3])


def test_native_step_limit_and_threads_and_empty():
    ds = generate_dataset(4, "medium", seed=33, solvable_fraction=0.0)
    for i in range(len(ds)):
        assert native.solve(int(ds.pegs[i]), int(ds.playable[i]),
                            max_steps=3)[2] <= 3
    ds = generate_dataset(100, "easy", seed=41)
    one = native.solve_batch(ds.pegs, ds.playable, n_threads=1)
    eight = native.solve_batch(ds.pegs, ds.playable, n_threads=8)
    for a, b in zip(one, eight):
        np.testing.assert_array_equal(a, b)
    assert len(native.solve_batch(np.zeros(0, np.uint32),
                                  np.zeros(0, np.uint32))[0]) == 0
    assert native.resolve_n_threads(0) == (os.cpu_count() or 1)
    assert native.resolve_n_threads(3) == 3


def test_solve_host_report():
    ds = generate_dataset(64, "easy", seed=51)
    rep = solve_host(ds, n_threads=4)
    assert rep.strategy == "host" and sum(rep.per_worker_games) == 64
    assert rep.n_solutions == sum(
        solve_one_py(int(p), int(q))[0] for p, q in zip(ds.pegs,
                                                        ds.playable))


@pytest.mark.parametrize("vocab,branch,batch,seq", [(97, 4, 5, 33),
                                                    (1000, 8, 3, 7)])
def test_markov_fill_matches_jax_fallback(vocab, branch, batch, seq):
    got = native.markov_fill(vocab, branch, 11, 2**63 + 5, batch, seq)
    want = jnative._markov_fill_py(vocab, branch, 11, 2**63 + 5, batch,
                                   seq, np.empty((batch, seq + 1),
                                                 np.int32))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        native._markov_fill_py(vocab, branch, 11, 2**63 + 5, batch, seq,
                               np.empty((batch, seq + 1), np.int32)),
        want)


def test_python_fallbacks_when_the_library_is_absent(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", "no toolchain (test)")
    assert not native.available()
    ds = generate_dataset(6, "easy", seed=3)
    text = (f"{len(ds)}\n" + "\n".join(ds.to_strings())).encode()
    np.testing.assert_array_equal(native.parse_boards(text)[0], ds.pegs)
    with pytest.raises(ValueError, match="header"):
        native.parse_boards(b"x 1")
    out = native.solve_batch(ds.pegs, ds.playable, return_workers=True)
    assert native.resolve_n_threads(0) == 1 and (out[4] == 0).all()
    ok, moves, _ = native.solve(*map(int, (ds.pegs[0], ds.playable[0])))
    assert ok == bool(out[0][0])
    assert native.trap_count() == 0 and native.install_traps() is False
    assert native.monotonic_s() > 0


def test_cdll_retried_once_after_failed_probe(monkeypatch):
    """A CDLL that fails on the first probe (a torn read mid-replace by
    a concurrent build) is retried once after a locked re-make."""
    real_cdll = ctypes.CDLL
    calls = {"n": 0}

    def flaky_cdll(path, *a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError("simulated torn .so")
        return real_cdll(path, *a, **kw)

    monkeypatch.setattr(native.ctypes, "CDLL", flaky_cdll)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    assert native.available(), native.build_error()
    assert calls["n"] == 2


def test_watchdog_soft_counts_alarm_and_restore_untraps():
    """Soft mode counts a trapped SIGALRM instead of dying; after
    restore_traps a SIGALRM is the default death again. The module is
    loaded alone (it needs no torch), in a process of its own."""
    r = _run("""
        import importlib.util, os, signal, time
        spec = importlib.util.spec_from_file_location(
            "port_native", "icikit_torch/native/__init__.py")
        native = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(native)
        assert native.available()
        native.watchdog_soft(True)
        assert native.install_traps()
        before = native.trap_count()
        native.watchdog(1)
        time.sleep(1.5)
        assert native.trap_count() == before + 1
        print("SOFT-OK", flush=True)
        native.watchdog_soft(False)
        assert native.restore_traps()
        os.kill(os.getpid(), signal.SIGALRM)
        print("SHOULD-NOT-PRINT")
    """)
    assert "SOFT-OK" in r.stdout, r.stderr
    assert "SHOULD-NOT-PRINT" not in r.stdout
    assert r.returncode == -14 and "icikit terminated" not in r.stderr


def test_watchdog_hard_kills_runaway():
    """The reference's point (utilities.cc:49-58): a hung run dies with
    a diagnostic instead of wedging the queue."""
    r = _run("""
        import time
        from icikit_torch.utils.guard import chopsigs
        chopsigs(1)
        time.sleep(30)
        print("SHOULD-NOT-PRINT")
    """)
    assert "SHOULD-NOT-PRINT" not in r.stdout
    assert "watchdog" in r.stderr and r.returncode == 2
