"""Peg-solitaire game model and DFS solver, on the card.

The port of ``icikit/models/solitaire/game.py``. The reference models
the 5x5 board as an enum array with a recursive solver
(``Dynamic-Load-Balancing/src/game.h:24-48``, ``game.cc:121-138``).
Here, as in JAX, a board is two uint32 bitmasks — ``pegs`` (bit c set
iff cell c holds a peg) and ``playable`` (bit c set iff cell c is not
NA) — so a move is three bit operations. JAX runs the exhaustive DFS as
a ``lax.while_loop`` over an explicit stack under ``vmap``, one device
program a batch; the port runs it as one CUDA kernel launch a batch,
one thread a board (``csrc/solitaire.cu``, wrapped by
``ops/cuda_solitaire.py``). :func:`solve_batch` routes a CUDA tensor to
that kernel and a CPU tensor to :func:`solve_batch_plain`, a PyTorch
loop that steps the whole batch once a DFS step by JAX's rules.

Rules (reference ``game.cc:54-97``): a move is named by its destination
hole (i, j) and a direction d; the peg two cells away in direction d
jumps over the adjacent peg into the hole, and both source cells become
holes. Move enumeration order is (i, j, d) lexicographic
(``game.cc:99-107``), which this module preserves exactly so the first
solution found matches the reference solver's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

IDIM = 5
JDIM = 5
N_CELLS = IDIM * JDIM
N_MOVES = N_CELLS * 4
MAX_DEPTH = N_CELLS  # a solution removes at most 24 pegs

# Solver status codes
RUNNING, SOLVED, EXHAUSTED, STEP_LIMIT = 0, 1, 2, 3

# Direction deltas, in the reference's order (game.cc:58-75):
# 0: jump from (i+2, j) upward; 1: from (i-2, j); 2: from (i, j+2);
# 3: from (i, j-2).
_DIRS = ((1, 0), (-1, 0), (0, 1), (0, -1))


def _build_move_tables():
    """Static tables over all 100 (destination cell, direction) moves.

    For move m = cell * 4 + d: DEST/MID/FAR are single-bit masks for the
    destination hole, the jumped peg, and the jumping peg; GEOM marks
    moves whose far cell is on the board (reference bounds checks,
    ``game.cc:85-95``).
    """
    dest = np.zeros(N_MOVES, np.uint32)
    mid = np.zeros(N_MOVES, np.uint32)
    far = np.zeros(N_MOVES, np.uint32)
    geom = np.zeros(N_MOVES, bool)
    for c in range(N_CELLS):
        i, j = divmod(c, JDIM)
        for d, (di, dj) in enumerate(_DIRS):
            m = c * 4 + d
            fi, fj = i + 2 * di, j + 2 * dj
            dest[m] = 1 << c
            if 0 <= fi < IDIM and 0 <= fj < JDIM:
                geom[m] = True
                mid[m] = 1 << ((i + di) * JDIM + (j + dj))
                far[m] = 1 << (fi * JDIM + fj)
    return dest, mid, far, geom


_DEST_NP, _MID_NP, _FAR_NP, _GEOM_NP = _build_move_tables()


# ---------------------------------------------------------------------------
# Board encoding (reference game_state::Init/SaveBoard, game.cc:26-53)

def parse_board(s: str) -> tuple[int, int]:
    """Parse a 25-char board string ('0' hole, '1' peg, other NA) into
    (pegs, playable) bitmasks."""
    if len(s) != N_CELLS:
        raise ValueError(f"board string must be {N_CELLS} chars, got {len(s)}")
    pegs = playable = 0
    for c, ch in enumerate(s):
        if ch == "1":
            pegs |= 1 << c
            playable |= 1 << c
        elif ch == "0":
            playable |= 1 << c
    return pegs, playable


def render_board(pegs: int, playable: int) -> str:
    """Inverse of parse_board: '0'/'1'/'2' per cell (reference SaveBoard
    encoding, ``game.cc:40-53``)."""
    out = []
    for c in range(N_CELLS):
        if pegs >> c & 1:
            out.append("1")
        elif playable >> c & 1:
            out.append("0")
        else:
            out.append("2")
    return "".join(out)


def pretty_board(pegs: int, playable: int) -> str:
    """Human rendering: 'X' peg, '*' hole, ' ' NA, one row per line.

    Matches the reference's ``Print`` (``game.cc:108-118``), including
    its column-major row order: output row r lists cells (i=0..4, j=r).
    """
    lines = []
    for j in range(JDIM):
        row = []
        for i in range(IDIM):
            c = i * JDIM + j
            if pegs >> c & 1:
                row.append("X")
            elif playable >> c & 1:
                row.append("*")
            else:
                row.append(" ")
        lines.append("".join(row))
    return "\n".join(lines) + "\n"


@dataclass
class BoardBatch:
    """A batch of boards as parallel uint32 bitmask arrays."""

    pegs: np.ndarray      # uint32[B]
    playable: np.ndarray  # uint32[B]

    @classmethod
    def from_strings(cls, boards: list[str]) -> "BoardBatch":
        parsed = [parse_board(b) for b in boards]
        return cls(
            pegs=np.array([p for p, _ in parsed], np.uint32),
            playable=np.array([q for _, q in parsed], np.uint32))

    def to_strings(self) -> list[str]:
        return [render_board(int(p), int(q))
                for p, q in zip(self.pegs, self.playable)]

    def __len__(self) -> int:
        return len(self.pegs)

    def __getitem__(self, idx) -> "BoardBatch":
        return BoardBatch(pegs=np.atleast_1d(self.pegs[idx]),
                          playable=np.atleast_1d(self.playable[idx]))


def apply_move(pegs: int, m: int) -> int:
    """Apply move m to a pegs mask (reference makeMove, game.cc:54-76)."""
    return int((pegs | int(_DEST_NP[m]))
               & ~(int(_MID_NP[m]) | int(_FAR_NP[m])) & 0x1FFFFFF)


def _valid_mask_py(pegs: int, playable: int) -> np.ndarray:
    """bool[100] move-validity mask (reference validMove, game.cc:78-97)."""
    pegs = np.uint32(pegs)
    playable = np.uint32(playable)
    return (_GEOM_NP
            & ((pegs & _MID_NP) == _MID_NP)
            & ((pegs & _FAR_NP) == _FAR_NP)
            & ((playable & _DEST_NP) != 0)
            & ((pegs & _DEST_NP) == 0))


def replay_moves(pegs: int, playable: int, moves) -> list[int]:
    """Replay a move sequence from an initial board, validating each move
    against the game rules. Returns the sequence of peg states (initial
    included). Raises if any move is illegal — the test oracle for
    solver outputs."""
    states = [pegs]
    for m in moves:
        m = int(m)
        if not _valid_mask_py(pegs, playable)[m]:
            raise ValueError(f"illegal move {m} from state {pegs:#x}")
        pegs = apply_move(pegs, m)
        states.append(pegs)
    return states


def render_solution(board: str, moves) -> str:
    """Render a solved game as board states joined by '-->', the
    reference's solution_found message payload
    (``Dynamic-Load-Balancing/src/main.cc:169-177``)."""
    pegs, playable = parse_board(board)
    states = replay_moves(pegs, playable, moves)
    parts = [pretty_board(states[0], playable)]
    for s in states[1:]:
        parts.append("-->\n")
        parts.append(pretty_board(s, playable))
    return "".join(parts)


# ---------------------------------------------------------------------------
# Pure-Python reference solver (test oracle)

def solve_one_py(pegs: int, playable: int,
                 max_steps: int | None = None) -> tuple[bool, list[int], int]:
    """Iterative DFS in plain Python, identical move order to the
    batched solvers. Returns (solved, moves, nodes_visited); past
    ``max_steps`` it returns ``max_steps + 1`` nodes, where
    :func:`solve_batch` stops at ``max_steps`` (JAX's two conventions,
    kept)."""
    stack = [(pegs, 0)]
    moves: list[int] = []
    steps = 0
    while stack:
        steps += 1
        if max_steps is not None and steps > max_steps:
            return False, [], steps
        cur, resume = stack[-1]
        valid = np.flatnonzero(_valid_mask_py(cur, playable))
        valid = valid[valid >= resume]
        if valid.size == 0:
            if bin(cur).count("1") == 1:
                return True, moves, steps
            stack.pop()
            if moves:
                moves.pop()
            continue
        m = int(valid[0])
        stack[-1] = (cur, m + 1)
        stack.append((apply_move(cur, m), 0))
        moves.append(m)
    return False, [], steps


# ---------------------------------------------------------------------------
# Batched solver: the plain PyTorch version and the routing entry point

_DEST_I64 = _DEST_NP.astype(np.int64)
_MID_I64 = _MID_NP.astype(np.int64)
_FAR_I64 = _FAR_NP.astype(np.int64)
MAX_STEPS_DEFAULT = 2_000_000_000
_INT32_MAX = 2**31 - 1


def as_u32_bits(x, device=None) -> torch.Tensor:
    """A board mask array (a tensor or anything numpy takes: uint32,
    int32 or int64) as an int64 tensor of its low 32 bits, on
    ``device`` (default: the tensor's own, else the CPU)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(np.asarray(x).astype(
            np.int64) & 0xFFFFFFFF))
    if x.dtype == torch.uint32:
        x = x.view(torch.int32)
    if x.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"board masks must be uint32, int32 or int64, "
                         f"got {x.dtype}")
    if device is not None:
        x = x.to(device)
    return x.to(torch.int64) & 0xFFFFFFFF


def check_max_steps(max_steps: int) -> int:
    """The step budget as the int32 JAX's ``solve_batch`` takes."""
    max_steps = int(max_steps)
    if max_steps > _INT32_MAX:
        raise ValueError(f"max_steps must fit in int32, got {max_steps}")
    return max_steps


def solve_batch_plain(pegs, playable,
                      max_steps: int = MAX_STEPS_DEFAULT) -> tuple:
    """JAX's ``_solve_one`` for every board of the batch, stepped from
    the host: each loop iteration is one DFS step of every board still
    running (JAX's ``vmap``'d ``lax.while_loop``). A step validates the
    node's 100 candidate moves against the tables, descends into the
    first valid one at or past the node's resume index, or, at a dead
    end, wins with one peg, exhausts at depth 0 or backtracks; a board
    stops after ``max_steps`` steps (``STEP_LIMIT``). A valid move
    toggles its three cells, so a backtrack toggles the parent's move
    back and the path is the only stack (as in the kernel). Boards that
    finish leave the live set. Returns (solved bool[B], n_moves
    int32[B], moves int32[B, 25], steps int32[B], status int32[B]) on
    the inputs' device. The kernel's oracle: ~30 small ops a step, so it
    is for small budgets."""
    max_steps = check_max_steps(max_steps)
    pegs = as_u32_bits(pegs)
    dev = pegs.device
    playable = as_u32_bits(playable, dev)
    b = pegs.shape[0]
    dest = torch.from_numpy(_DEST_I64).to(dev)
    mid_far = torch.from_numpy(_MID_I64 | _FAR_I64).to(dev)
    toggle = torch.from_numpy(_DEST_I64 | _MID_I64 | _FAR_I64).to(dev)
    geom = torch.from_numpy(_GEOM_NP).to(dev)
    move_idx = torch.arange(N_MOVES, device=dev)
    i64 = torch.int64
    # results, filled as boards finish
    status = torch.full((b,), STEP_LIMIT, dtype=i64, device=dev)
    depth_out = torch.zeros(b, dtype=i64, device=dev)
    steps = torch.zeros(b, dtype=i64, device=dev)
    moves_out = torch.full((b, MAX_DEPTH), -1, dtype=i64, device=dev)
    # the live boards' state: node, depth, resume index, path
    rows = torch.arange(b, device=dev)
    cur = pegs.clone()
    base = geom & ((playable[:, None] & dest) != 0)
    depth = torch.zeros(b, dtype=i64, device=dev)
    resume = torch.zeros(b, dtype=i64, device=dev)
    path = torch.zeros((b, MAX_DEPTH), dtype=i64, device=dev)
    taken = 0   # steps of every live board
    while rows.numel() and taken < max_steps:
        taken += 1
        valid = (((cur[:, None] & (mid_far | dest)) == mid_far) & base
                 & (move_idx >= resume[:, None]))
        has = valid.any(1)
        first = valid.to(torch.uint8).argmax(1)
        # past the path's end for a dead end (depth <= 24): harmless
        path.scatter_(1, depth[:, None], first[:, None])
        parent = path.gather(1, (depth - 1).clamp(min=0)[:, None])[:, 0]
        one = (cur != 0) & ((cur & (cur - 1)) == 0)
        dead = ~has
        # a dead end with one peg wins; else, at depth 0, exhausts
        done = dead & (one | (depth == 0))
        back = dead & ~done
        cur = torch.where(has, cur ^ toggle[first],
                          torch.where(back, cur ^ toggle[parent], cur))
        resume = torch.where(has, 0, parent + 1)
        depth = depth + has.to(i64) - back.to(i64)
        if bool(done.any()):
            r = rows[done]
            won = one[done]
            status[r] = torch.where(won, SOLVED, EXHAUSTED)
            depth_out[r] = depth[done]
            steps[r] = taken
            moves_out[r] = path[done]
            keep = ~done
            rows, cur, base, depth, resume, path = (
                rows[keep], cur[keep], base[keep], depth[keep],
                resume[keep], path[keep])
    steps[rows] = taken
    solved = status == SOLVED
    n_moves = torch.where(solved, depth_out, 0)
    keep = (move_idx[:MAX_DEPTH] < n_moves[:, None]) & solved[:, None]
    moves = torch.where(keep, moves_out, -1)
    i32 = torch.int32
    return (solved, n_moves.to(i32), moves.to(i32), steps.to(i32),
            status.to(i32))


def solve_batch(pegs, playable, max_steps: int = MAX_STEPS_DEFAULT,
                device=None) -> tuple:
    """Solve a batch of boards. Returns (solved bool[B], n_moves
    int32[B], moves int32[B, 25], steps int32[B], status int32[B]) on
    the boards' device, JAX's ``solve_batch`` bit for bit.

    ``pegs`` and ``playable`` are uint32, int32 or int64 tensors (their
    low 32 bits) or arrays; ``device`` places arrays (default: the
    card) and moves tensors. On a CUDA device the batch is one launch of
    the DFS kernel (``ops.cuda_solitaire.solve_dfs``), on the current
    stream; a failed build or launch raises. On the CPU it takes
    :func:`solve_batch_plain`.

    ``steps`` is the per-board DFS node count — the load-imbalance
    signal the scheduling study measures. In one launch a warp runs
    until its slowest board finishes: the card's own form of the
    imbalance the batch-level schedulers (``scheduler.py``) absorb.
    """
    if device is None and not isinstance(pegs, torch.Tensor):
        device = "cuda"
    if device is not None:
        device = torch.device(device)
    pegs = pegs if isinstance(pegs, torch.Tensor) else as_u32_bits(pegs)
    playable = (playable if isinstance(playable, torch.Tensor)
                else as_u32_bits(playable))
    if device is not None:
        pegs, playable = pegs.to(device), playable.to(device)
    if pegs.shape != playable.shape or pegs.dim() != 1:
        raise ValueError(f"pegs and playable must be 1-d of one length, "
                         f"got {tuple(pegs.shape)} and "
                         f"{tuple(playable.shape)}")
    if pegs.device.type == "cuda":
        from icikit_torch.ops.cuda_solitaire import solve_dfs
        return solve_dfs(pegs, playable, max_steps)
    if pegs.device.type != "cpu":
        raise ValueError(f"solve_batch: expected a CUDA or CPU device, got "
                         f"{pegs.device}")
    return solve_batch_plain(pegs, playable, max_steps)
