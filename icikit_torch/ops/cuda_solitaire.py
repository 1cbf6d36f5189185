"""The peg-solitaire DFS on Hopper: wrapper, launch count.

``solve_dfs`` launches ``csrc/solitaire.cu``'s ``solve_dfs_kernel``
(I2) once for the whole batch: one thread a board at a time, at most
two blocks of 64 threads an SM, the lanes of a block taking its range
of boards in turn (the board's DFS is ``csrc/solitaire_dfs.cuh``). It
replaces no Pallas kernel: in JAX the DFS is a ``lax.while_loop`` under ``vmap``
that XLA compiles into one device program a batch
(``icikit/models/solitaire/game.py:242-313``). Its plain version is
``models.solitaire.game.solve_batch_plain``, which steps the batch from
the host; kernel and plain version agree bit for bit on all five
outputs (the DFS is exact integer work). A failed build or launch
raises. ``LAUNCHES`` counts kernel launches (an empty batch launches
nothing); scheduler workers launch from several threads, so the count
takes a lock.
"""

from __future__ import annotations

import threading

import torch

from icikit_torch.ops import _build

LAUNCHES = {"solve_dfs": 0}
_count_lock = threading.Lock()
_ENTRY: list = []   # the C entry, bound at first use
MAX_DEPTH = 25


def reset_launches() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _entry():
    if not _ENTRY:
        _ENTRY.append(_build.load("solitaire").icikit_solve_dfs)
    return _ENTRY[0]


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """A uint32, int32 or int64 mask tensor as a contiguous uint32 one
    holding its low 32 bits, on its own device."""
    if x.dtype == torch.uint32:
        return x.contiguous()
    if x.dtype == torch.int64:
        x = x & 0xFFFFFFFF
        x = (x - ((x >> 31) << 32)).to(torch.int32)
    if x.dtype != torch.int32:
        raise ValueError(f"solve_dfs: board masks must be uint32, int32 or "
                         f"int64, got {x.dtype}")
    return x.contiguous().view(torch.uint32)


def solve_dfs(pegs: torch.Tensor, playable: torch.Tensor,
              max_steps: int) -> tuple:
    """(solved bool[B], n_moves int32[B], moves int32[B, 25], steps
    int32[B], status int32[B]) of JAX's ``solve_batch`` for CUDA masks
    ``pegs`` and ``playable`` (uint32, int32 or int64: their low 32
    bits), in one launch on the current stream. ``max_steps`` must fit
    in int32; a negative budget takes no step (``STEP_LIMIT``)."""
    from icikit_torch.models.solitaire.game import check_max_steps
    max_steps = check_max_steps(max_steps)
    for t in (pegs, playable):
        if t.device.type != "cuda":
            raise ValueError(f"solve_dfs: expected CUDA tensors, got "
                             f"{t.device}")
    if pegs.device != playable.device or pegs.shape != playable.shape \
            or pegs.dim() != 1:
        raise ValueError("solve_dfs: pegs and playable must be 1-d tensors "
                         "of one length on one device")
    pegs, playable = as_u32(pegs), as_u32(playable)
    n, dev = pegs.shape[0], pegs.device
    solved = torch.empty(n, dtype=torch.uint8, device=dev)
    n_moves = torch.empty(n, dtype=torch.int32, device=dev)
    moves = torch.empty((n, MAX_DEPTH), dtype=torch.int32, device=dev)
    steps = torch.empty(n, dtype=torch.int32, device=dev)
    status = torch.empty(n, dtype=torch.int32, device=dev)
    rc = _entry()(pegs.data_ptr(), playable.data_ptr(), n, max(max_steps, 0),
                  solved.data_ptr(), n_moves.data_ptr(), moves.data_ptr(),
                  steps.data_ptr(), status.data_ptr(), _build.stream(pegs))
    _build.check(rc, "solve_dfs launch")
    if n:
        with _count_lock:
            LAUNCHES["solve_dfs"] += 1
    return solved.view(torch.bool), n_moves, moves, steps, status
