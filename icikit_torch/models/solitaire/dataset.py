"""Peg-solitaire datasets: reference-format I/O and graded generators.

The port of ``icikit/models/solitaire/dataset.py``: the same format and
the same numpy generators, so the same ``(n_games, grade, seed)`` gives
the same boards, bit for bit, in both packages.

On-disk format is the reference's
(``Dynamic-Load-Balancing/src/main.cc:49-66``):
first line is the game count, then one 25-char board row per game
('0' hole, '1' peg, '2' NA). ``.gz`` paths are transparently
decompressed, matching the reference's ``Data/big_set/*.dat.gz``
fixtures.

The reference ships fixed datasets graded easy/medium/hard; the grading
exists to stress the load balancer with variable DFS cost
(SURVEY.md §4.4). Instead of shipping opaque fixtures, this module
*generates* graded datasets deterministically: solvable boards are built
by running the jump rule backwards from a single peg (k reverse jumps
yield a board with k+1 pegs that is solvable by construction), and
distractor boards are random peg placements (usually unsolvable at
higher peg counts). Difficulty scales with peg count — DFS node count
grows exponentially in it.
"""

from __future__ import annotations

import gzip
import os

import numpy as np

from icikit_torch.models.solitaire.game import (
    N_CELLS,
    BoardBatch,
    _DEST_NP,
    _FAR_NP,
    _GEOM_NP,
    _MID_NP,
)

# Peg-count ranges per difficulty grade. DFS cost is exponential in peg
# count, so these spans produce the wide per-board cost variance the
# scheduling study needs (easy boards solve in tens of nodes, hard in
# millions).
GRADES = {
    "easy": (6, 9),
    "medium": (9, 12),
    "hard": (12, 16),
}


def _open(path, mode):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode + "t")
    return open(path, mode)


def load_dataset(path) -> BoardBatch:
    """Load a reference-format dataset (count line + 25-char rows).

    Parsing goes through the port's native one-pass parser when
    available (``icikit_torch/native/src/dataset.cc``); errors surface
    as ValueError either way."""
    with _open(path, "r") as f:
        text = f.read()
    from icikit_torch import native
    try:
        pegs, playable = native.parse_boards(text.encode())
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    return BoardBatch(pegs=pegs, playable=playable)


def save_dataset(path, batch: BoardBatch) -> None:
    """Write a dataset in the reference's on-disk format."""
    with _open(path, "w") as f:
        f.write(f"{len(batch)}\n")
        for row in batch.to_strings():
            f.write(row + "\n")


def _reverse_step(rng: np.random.Generator, pegs: int, playable: int) -> int:
    """Apply one random *reverse* jump: a peg at a move's destination
    un-jumps, leaving pegs at the mid and far cells. The inverse of
    ``makeMove`` (``game.cc:54-76``), so any board reached this way is
    solvable by construction. Returns the new pegs mask, or ``pegs``
    unchanged if no reverse move exists."""
    p = np.uint32(pegs)
    q = np.uint32(playable)
    # Reverse-valid: destination currently a peg; mid and far currently
    # playable holes.
    valid = (_GEOM_NP
             & ((p & _DEST_NP) != 0)
             & ((q & _MID_NP) == _MID_NP) & ((p & _MID_NP) == 0)
             & ((q & _FAR_NP) == _FAR_NP) & ((p & _FAR_NP) == 0))
    idx = np.flatnonzero(valid)
    if idx.size == 0:
        return pegs
    m = int(rng.choice(idx))
    return int((p & ~_DEST_NP[m]) | _MID_NP[m] | _FAR_NP[m])


def make_solvable_board(rng: np.random.Generator, n_pegs: int,
                        playable: int | None = None) -> tuple[int, int]:
    """Build a solvable board with (up to) ``n_pegs`` pegs by reverse
    jumps from a random single peg."""
    if playable is None:
        playable = (1 << N_CELLS) - 1
    cells = np.flatnonzero(
        [(playable >> c) & 1 for c in range(N_CELLS)])
    pegs = 1 << int(rng.choice(cells))
    for _ in range(n_pegs - 1):
        new = _reverse_step(rng, pegs, playable)
        if new == pegs:
            break  # saturated: no reverse move available
        pegs = new
    return pegs, playable


def make_random_board(rng: np.random.Generator, n_pegs: int,
                      playable: int | None = None) -> tuple[int, int]:
    """Random peg placement — solvability not guaranteed (the hard
    datasets' many unsolvable boards are what make their DFS cost
    explode: the search must exhaust the whole tree to prove failure)."""
    if playable is None:
        playable = (1 << N_CELLS) - 1
    cells = np.flatnonzero([(playable >> c) & 1 for c in range(N_CELLS)])
    chosen = rng.choice(cells, size=min(n_pegs, cells.size), replace=False)
    pegs = 0
    for c in chosen:
        pegs |= 1 << int(c)
    return pegs, playable


def generate_dataset(n_games: int, grade: str = "easy",
                     seed: int = 0, solvable_fraction: float = 0.7,
                     ) -> BoardBatch:
    """Generate a deterministic graded dataset.

    ``solvable_fraction`` of the boards are solvable by construction;
    the rest are random placements. Determinism mirrors the reference's
    p-invariant input generation discipline (``psort.cc:575-581``):
    the same (n_games, grade, seed) always yields the same boards, so
    solution counts are golden values any scheduler must reproduce.
    """
    if grade not in GRADES:
        raise ValueError(f"grade must be one of {sorted(GRADES)}")
    lo, hi = GRADES[grade]
    rng = np.random.default_rng(seed)
    pegs_out = np.zeros(n_games, np.uint32)
    playable_out = np.zeros(n_games, np.uint32)
    full = (1 << N_CELLS) - 1
    for g in range(n_games):
        n_pegs = int(rng.integers(lo, hi + 1))
        if rng.random() < solvable_fraction:
            p, q = make_solvable_board(rng, n_pegs, full)
        else:
            p, q = make_random_board(rng, n_pegs, full)
        pegs_out[g] = p
        playable_out[g] = q
    return BoardBatch(pegs=pegs_out, playable=playable_out)


def generate_skewed_dataset(n_games: int, seed: int = 0,
                            hard_fraction: float = 0.125) -> BoardBatch:
    """A deterministic dataset with adversarially *placed* cost skew:
    the last ``hard_fraction`` of the boards are hard (deep DFS), the
    rest easy. A static contiguous split hands every hard board to the
    final worker — the exact variable-cost scenario the reference's
    dynamic farm exists for (``Dynamic-Load-Balancing/README.md:5``);
    the imbalance study (tests/test_solitaire.py, bench.northstar)
    measures how much of that skew each scheduler absorbs."""
    n_hard = max(1, int(n_games * hard_fraction))
    easy = generate_dataset(n_games - n_hard, "easy", seed=seed)
    hard = generate_dataset(n_hard, "hard", seed=seed + 1)
    return BoardBatch(
        pegs=np.concatenate([easy.pegs, hard.pegs]),
        playable=np.concatenate([easy.playable, hard.playable]))


def dataset_dir() -> str:
    """Repo-local Data/ directory (reference
    ``Dynamic-Load-Balancing/Data``)."""
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(os.path.dirname(os.path.dirname(here)))
    return os.path.join(root, "Data", "solitaire")
