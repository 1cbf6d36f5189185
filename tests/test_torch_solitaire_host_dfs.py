"""The DFS kernel's arithmetic on the host, against JAX and the native
solver.

``icikit_torch/csrc/solitaire_dfs.cuh`` holds one board's DFS as the
kernel ``solve_dfs_kernel`` (I2) runs it: the step, the push, the pop
and the output row. It includes no CUDA header, so g++ compiles it here
with a small C++ wrapper (stubs for ``__ffs``, ``__popc``,
``__any_sync`` and ``__reduce_min_sync``; one lane that takes every
board in turn through the kernel's refill, path stride 1). Its five
outputs are held bit for bit to JAX's ``solve_batch`` at small budgets
(graded boards, the edge boards of ``tests/test_solitaire.py``, random
32-bit masks) and to the port's native host solver at 500,000 steps.
What only the card can show (a warp's lanes in step, the lanes without
a board, the block's board counter, the shared-memory path) is in
``tests/test_torch_cuda_kernels.py -k solve_dfs``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest

from icikit.models.solitaire import dataset as jds
from icikit.models.solitaire import game as jgame
from icikit_torch.models.solitaire import dataset as tds
from icikit_torch.models.solitaire.game import BoardBatch
from icikit_torch.models.solitaire.scheduler import solve_host

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "icikit_torch", "csrc")
EDGES = ("1" + "0" * 24, "0" * 25, "1" * 25, "111" + "0" * 22,
         "110" + "0" * 22, "11000" * 2 + "0" * 15, "112" + "0" * 22)

WRAPPER = r"""
#include <stdint.h>
#include <string.h>
static inline int __ffs(uint32_t x) { return __builtin_ffs((int)x); }
static inline int __popc(uint32_t x) { return __builtin_popcount(x); }
static inline bool __any_sync(unsigned, bool p) { return p; }
static inline unsigned __reduce_min_sync(unsigned, unsigned v) { return v; }
#include "solitaire_dfs.cuh"
extern "C" void host_solve(const uint32_t* pegs, const uint32_t* playable,
                           int64_t n, int max_steps, int live,
                           uint8_t* solved, int32_t* n_moves,
                           int32_t* moves, int32_t* steps,
                           int32_t* status) {
  dfs::Moves path_moves[dfs::SLOTS];
  uint32_t path_togs[dfs::SLOTS];
  memset(path_moves, 0, sizeof path_moves);
  memset(path_togs, 0, sizeof path_togs);
  const dfs::Batch bt{pegs, playable, max_steps < 0 ? 0 : max_steps,
                      solved, n_moves, moves, steps, status};
  int taken = 1;  // one lane: each board in turn, by the refill
  dfs::solve_lane(bt, 0, (int)n, live ? 0 : (int)n, path_moves, path_togs,
                  1, [&]() { return taken++; });
}
"""


@pytest.fixture(scope="module")
def host_dfs(tmp_path_factory):
    """The header built with g++ into a temporary directory."""
    cxx = shutil.which("g++")
    assert cxx, "g++ is needed to build the header on the host"
    d = tmp_path_factory.mktemp("host_dfs")
    src, lib = d / "wrapper.cc", d / "libhostdfs.so"
    src.write_text(WRAPPER)
    r = subprocess.run([cxx, "-O2", "-std=c++17", "-Wall", "-Werror",
                        "-Wno-unknown-pragmas", "-shared", "-fPIC",
                        f"-I{CSRC}", "-o", str(lib), str(src)],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    fn = ctypes.CDLL(str(lib)).host_solve
    p = ctypes.c_void_p
    fn.argtypes = [p, p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                   p, p, p, p, p]
    fn.restype = None

    def solve(pegs, playable, max_steps, live=True, fill=0):
        pegs, playable = (np.ascontiguousarray(
            (np.asarray(x).astype(np.int64) & 0xFFFFFFFF).astype(np.uint32))
            for x in (pegs, playable))
        n = len(pegs)
        out = [np.full(n, fill, np.uint8), np.full(n, fill, np.int32),
               np.full((n, 25), fill, np.int32), np.full(n, fill, np.int32),
               np.full(n, fill, np.int32)]
        fn(pegs.ctypes.data, playable.ctypes.data, n, int(max_steps),
           int(live), *(o.ctypes.data for o in out))
        out[0] = out[0].astype(bool)
        return out

    return solve


def _assert_same(want, got):
    for name, a, b in zip(("solved", "n_moves", "moves", "steps", "status"),
                          want, got):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("grade,n,seed,max_steps", [
    ("easy", 64, 1, 2000), ("medium", 48, 1, 3000), ("hard", 16, 1, 3000),
    ("easy", 48, 7, 2_000_000_000), ("medium", 32, 2, 1),
    ("hard", 8, 0, 7)])
def test_graded_boards_match_jax(host_dfs, grade, n, seed, max_steps):
    ds = jds.generate_dataset(n, grade, seed=seed)
    _assert_same(jgame.solve_batch(ds.pegs, ds.playable, max_steps),
                 host_dfs(ds.pegs, ds.playable, max_steps))


@pytest.mark.parametrize("max_steps", [0, 1, 2, 3, 2000, 2_000_000_000])
def test_edge_boards_match_jax(host_dfs, max_steps):
    b = BoardBatch.from_strings(list(EDGES))
    got = host_dfs(b.pegs, b.playable, max_steps)
    _assert_same(jgame.solve_batch(b.pegs, b.playable, max_steps), got)


@pytest.mark.parametrize("seed,form", [(0, "any"), (1, "any"),
                                       (0, "on_board"), (2, "off_board")])
def test_random_bits_match_jax(host_dfs, seed, form):
    """Masks with bits past the 25 cells and pegs off the playable cells:
    the win test as a depth compare holds for them too."""
    rng = np.random.default_rng(seed)
    pegs = rng.integers(0, 2**32, 256, dtype=np.uint64).astype(np.uint32)
    play = rng.integers(0, 2**32, 256, dtype=np.uint64).astype(np.uint32)
    if form == "on_board":
        pegs = pegs & play & 0x1FFFFFF
    elif form == "off_board":
        # one peg on the board and the rest past cell 24: a win needs
        # popc over all 32 bits, as JAX counts
        pegs = (pegs & 0xFE000000) | (pegs & play & 0x1FFFFFF)
    _assert_same(jgame.solve_batch(pegs, play, 3000),
                 host_dfs(pegs, play, 3000))


def test_capped_hard_boards_match_native_solver(host_dfs):
    """At the study's budget, where many hard boards hit the cap."""
    ds = tds.generate_dataset(64, "hard", seed=0)
    host = solve_host(ds, max_steps=500_000)
    got = host_dfs(ds.pegs, ds.playable, 500_000)
    _assert_same((host.solved, host.n_moves, host.moves,
                  host.steps.astype(np.int32), host.status.astype(np.int32)),
                 got)
    assert (got[4] == jgame.STEP_LIMIT).sum() > 0
    assert got[3].max() == 500_000


@pytest.mark.parametrize("max_steps", [0, 5, 2000])
def test_stopped_lanes_write_nothing(host_dfs, max_steps):
    """A board past the batch (``live`` false) leaves its row as it was:
    the kernel's lanes past n run the loop stopped."""
    ds = jds.generate_dataset(8, "medium", seed=3)
    out = host_dfs(ds.pegs, ds.playable, max_steps, live=False, fill=7)
    for o in out:
        assert (o.astype(np.int64) == (1 if o.dtype == bool else 7)).all()
