"""The collective transport: every exchange of a rank-vectorised
schedule goes through :func:`ppermute`, which is the plain gather until
a checked-mode :class:`Tracker` is installed.

Ranks are the leading axis of one tensor (``utils.mesh.RankMesh``), so
a permutation is a gather along dim 0. The index tensors of a schedule
are static: :func:`index` builds each once per device and keeps it, so
an exchange issues no host-to-device copy after its first call (a copy
from pageable host memory would make the host wait for the stream to
drain).

Checked mode is ``icikit.parallel.transport``'s, rank-vectorised: a
"device" is rank r, row r of dim 0. Under a :class:`Tracker`, every
:func:`ppermute` folds one exact uint32 checksum per rank row of what
it sends (:func:`segment_checksum`, JAX's bit fold), moves the
checksums by the same permutation as the payload, and compares them
with the fold of what each rank received: a (p,) bool ``ok`` a step,
kept on the device. The corruption site (:func:`traced_flip`) sits
between the receive and the receiver's fold. Contracts:

- **Zero overhead unchecked.** With no tracker installed,
  :func:`ppermute` costs one thread-local read and a ``None`` check
  over the plain gather.
- **Bit-exact checksums.** The fold is JAX's bit for bit, so any single
  bit flip changes it and a clean run never flags.
- **Bit-identical when armed but cold.** The taint is decided on the
  host (``chaos.traced_corrupt_spec``), so a cold one touches nothing:
  the checked schedule's output is the unchecked schedule's.
"""

from __future__ import annotations

import threading
from functools import lru_cache

import torch

from icikit_torch.ops.cuda_integrity import INT_OF_WIDTH
from icikit_torch.ops.cuda_integrity import segment_checksum  # noqa: F401

_local = threading.local()


@lru_cache(maxsize=None)
def index(values: tuple, device, dtype=torch.long) -> torch.Tensor:
    """The constant tensor ``values`` on ``device``, built once: the
    static index (or mask) tensors of a schedule."""
    return torch.tensor(values, dtype=dtype, device=device)


@lru_cache(maxsize=None)
def _plan(perm: tuple, p: int):
    """(inverse, None) for a full permutation, else (src, dst)."""
    if len(perm) == p:
        inv = [0] * p
        for s, d in perm:
            inv[d] = s
        return tuple(inv), None
    return tuple(s for s, _ in perm), tuple(d for _, d in perm)


def plain_ppermute(a: torch.Tensor, perm) -> torch.Tensor:
    """``lax.ppermute`` over the rank axis: for each ``(src, dst)`` in
    ``perm``, ``out[dst] = a[src]``; ranks that receive nothing get
    zeros, as in ``lax.ppermute``. A full permutation is one gather.
    The result is a new tensor, never a view of ``a``."""
    src, dst = _plan(tuple(map(tuple, perm)), a.shape[0])
    if dst is None:
        return a.index_select(0, index(src, a.device))
    out = torch.zeros_like(a)
    if src:
        out.index_copy_(0, index(dst, a.device),
                        a.index_select(0, index(src, a.device)))
    return out


def _tracker():
    return getattr(_local, "tracker", None)


class Tracker:
    """Accumulator of one checked run of a schedule.

    Install with :class:`checked` around the run; every :func:`ppermute`
    inside then carries checksums and records a (p,) bool ``ok`` on the
    device. ``taint`` is the host-side corruption control (int32
    ``[step, rank, elem_seed, bit]``, ``step < 0`` disarmed; see
    ``chaos.traced_corrupt_spec``). ``axis`` names the mesh axis, as in
    JAX; the port's ranks are one axis, so every exchange is tracked.
    """

    def __init__(self, axis: str, taint):
        self.axis = axis
        self.taint = taint
        self.oks: list = []

    @property
    def calls(self) -> int:
        return len(self.oks)

    def verdict(self, p: int, device) -> torch.Tensor:
        """The (p, n_steps) bool verdict on the device; ones((p, 1))
        when there was no exchange (p = 1 verifies vacuously)."""
        if not self.oks:
            return torch.ones((p, 1), dtype=torch.bool, device=device)
        return torch.stack(self.oks, dim=1)

    def checked_ppermute(self, x: torch.Tensor, perm) -> torch.Tensor:
        idx = len(self.oks)
        cs = segment_checksum(x)
        y = plain_ppermute(x, perm)
        cs_r = plain_ppermute(cs, perm)
        # the in-transit corruption site: between the sender's checksum
        # and the receiver's, like a flipped wire or core
        y = traced_flip(y, self.taint, idx)
        self.oks.append(segment_checksum(y) == cs_r)
        return y


class checked:
    """Install ``tracker`` for the duration of a run (re-entrant: the
    innermost tracker wins, the previous one is restored)."""

    def __init__(self, tracker: Tracker):
        self.tracker = tracker

    def __enter__(self) -> Tracker:
        self._prev = _tracker()
        _local.tracker = self.tracker
        return self.tracker

    def __exit__(self, *exc):
        _local.tracker = self._prev
        return False


def ppermute(a: torch.Tensor, perm) -> torch.Tensor:
    """:func:`plain_ppermute`, with checked-mode interposition: under an
    installed :class:`Tracker` the block travels with its checksums,
    verified on the receiving ranks at this step."""
    t = _tracker()
    if t is None:
        return plain_ppermute(a, perm)
    return t.checked_ppermute(a, perm)


# -- the corruption site ----------------------------------------------
# (the fold, ``segment_checksum``, is ``ops.cuda_integrity``'s: the
# kernel on a CUDA tensor, its plain version on a CPU one; (p, ...) in,
# (p,) int32 holding each rank row's uint32 fold out)


def traced_flip(x: torch.Tensor, taint, call_idx: int) -> torch.Tensor:
    """The in-schedule corruption site (the device-side SDC drill).

    ``taint`` is int32 ``[step, rank, elem_seed, bit]`` on the host: when
    ``step == call_idx``, one bit (``bit`` mod the element's width) of
    element ``elem_seed`` mod the row's size in row ``rank`` of ``x`` is
    flipped in place, as JAX's flips it on device ``rank``; bool
    payloads flip a bit of their uint8 view and read back as ``!= 0``,
    as JAX's. Otherwise ``x`` is returned untouched. ``x`` must be a
    new tensor (the received block), never a view of the sender's."""
    if taint is None or int(taint[0]) != call_idx:
        return x
    p = x.shape[0]
    row = x.numel() // p if p else 0
    rank = int(taint[1])
    if row == 0 or not 0 <= rank < p:
        return x
    width = x.element_size()
    if width not in INT_OF_WIDTH:
        raise ValueError(f"traced_flip: no integer view of {x.dtype}")
    u = x.view(INT_OF_WIDTH[width]).view(p, row)
    mask = 1 << (int(taint[3]) % (8 * width))
    if width > 1 and mask >= 1 << (8 * width - 1):
        mask -= 1 << (8 * width)   # the same bits as a signed lane
    u[rank, int(taint[2]) % row] ^= mask
    return u.view(x.shape) != 0 if x.dtype == torch.bool else x
