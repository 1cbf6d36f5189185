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

The process backend: across OS processes (``utils.mesh.RankMesh.procs``
> 1) a schedule runs under a :class:`ProcessView`, installed by
:class:`processes` as :class:`checked` installs a tracker. The view's
process holds ranks ``[lo, hi)`` of the axis's p as its rows, so a
schedule body sees ``(hi - lo, ...)`` operands and every per-rank list
of ``parallel.shmap`` is cut to ``[lo, hi)``. :func:`ppermute` then
splits a permutation into its local pairs (one gather, as in one
process) and its remote ones, which cross as one batched
``torch.distributed`` send and one receive per peer process
(``batch_isend_irecv``). The backend is the one the group was started
with (gloo by default, which carries host tensors: a block of a CUDA
tensor crosses through pinned host memory, and every kernel and every
other tensor stays on the card). :data:`WIRE` counts what crossed. With
no view installed, :func:`ppermute` reads one thread-local more. Checked
mode works under a view: a remote pair's block and its checksums cross
in one batch, and the receiving process folds and compares them.

The vendor collectives (the ``xla`` variants, and the all-gathers and
psums inside the sorts and the ragged exchange) are PyTorch ops over the
rank axis in one process, so nothing marks them as communication. Each
site hands its result to :func:`vendor`, which an installed tracker may
record (``bench.schedule_stats`` counts calls, bytes and depth so) and
which costs a thread-local read otherwise.
"""

from __future__ import annotations

import threading
from functools import lru_cache

import torch
import torch.distributed as dist

from icikit_torch.ops.cuda_integrity import INT_OF_WIDTH
from icikit_torch.ops.cuda_integrity import segment_checksum  # noqa: F401
from icikit_torch.utils.mesh import split_ranks

_local = threading.local()

# What crossed the process boundary in this process since the last
# reset_wire(): messages and bytes sent and received by the process
# backend (payload only; the gloo wire's own framing is not counted).
# ``collective_*`` counts the backend's own collectives (the ``xla``
# variants' and the sort verifier's sums) by the bytes handed to them.
WIRE = {"messages": 0, "bytes_sent": 0, "bytes_received": 0,
        "collectives": 0, "collective_bytes": 0}


def reset_wire() -> None:
    for k in WIRE:
        WIRE[k] = 0


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
        v = process_view()
        if v is None:
            y, cs_r, lo = plain_ppermute(x, perm), plain_ppermute(cs, perm), 0
        else:  # the block and its checksums cross in one batch
            (y, cs_r), lo = v.ppermute_group((x, cs), perm), v.lo
        # the in-transit corruption site: between the sender's checksum
        # and the receiver's, like a flipped wire or core
        y = traced_flip(y, self.taint, idx, lo)
        self.oks.append(segment_checksum(y) == cs_r)
        return y

    def on_vendor(self, prim: str, operand: torch.Tensor, out: torch.Tensor,
                  per_rank_bytes) -> torch.Tensor:
        """A vendor collective's result inside the tracked run: one
        opaque op with no receive step, so nothing to verify."""
        return out


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
    verified on the receiving ranks at this step; under an installed
    :class:`ProcessView`, ``a`` holds this process's ranks and pairs
    with a rank of another process cross the process backend."""
    t = _tracker()
    if t is not None:
        return t.checked_ppermute(a, perm)
    v = process_view()
    return plain_ppermute(a, perm) if v is None else v.ppermute(a, perm)


def vendor(prim: str, operand: torch.Tensor, out: torch.Tensor,
           per_rank_bytes: int | None = None) -> torch.Tensor:
    """Mark ``out`` as the result of one vendor collective on
    ``operand``, JAX's primitive ``prim`` (``all_gather``,
    ``all_to_all``, ``psum``, ``pmax``, ``pmin``, ``reduce_scatter``),
    each rank sending ``per_rank_bytes`` (default: one rank's row of
    ``operand``). Returns ``out``, or what an installed tracker makes of
    it."""
    t = _tracker()
    if t is None:
        return out
    return t.on_vendor(prim, operand, out, per_rank_bytes)


# -- the process backend ----------------------------------------------


def process_view():
    """The installed :class:`ProcessView`, or None (one process)."""
    return getattr(_local, "view", None)


@lru_cache(maxsize=None)
def _proc_plan(perm: tuple, p: int, k: int, proc: int):
    """A permutation as this process sees it (process i holds ranks
    [i k, (i + 1) k)): (local sources, local destinations) of its
    pairs inside the process, per peer process the local rows it sends
    and the local rows it receives into (each in the order of
    ``perm``, the order both sides agree on), and whether every local
    rank receives."""
    lo = proc * k
    ls, ld, sends, recvs = [], [], {}, {}
    for s, d in perm:
        if not (0 <= s < p and 0 <= d < p):
            raise ValueError(f"pair {(s, d)} outside the {p} ranks")
        src_mine, dst_mine = s // k == proc, d // k == proc
        if src_mine and dst_mine:
            ls.append(s - lo)
            ld.append(d - lo)
        elif src_mine:
            sends.setdefault(d // k, []).append(s - lo)
        elif dst_mine:
            recvs.setdefault(s // k, []).append(d - lo)
    full = len(ld) + sum(map(len, recvs.values())) == k
    return (tuple(ls), tuple(ld),
            tuple((q, tuple(v)) for q, v in sorted(sends.items())),
            tuple((q, tuple(v)) for q, v in sorted(recvs.items())), full)


def _to_wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` as contiguous host bytes: staged through pinned memory
    when ``t`` lies on the card."""
    t = t.contiguous()
    if t.is_cuda:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        t = h
    return t.reshape(-1).view(torch.uint8)


def _wire_buffer(shape, dtype, like: torch.Tensor) -> torch.Tensor:
    """A host receive buffer of ``shape`` and ``dtype``, as bytes
    (pinned when it is bound for the card)."""
    h = torch.empty(shape, dtype=dtype, pin_memory=like.is_cuda)
    return h.reshape(-1).view(torch.uint8)


_REDUCE_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


class ProcessView:
    """The p ranks of one mesh axis split across the processes of the
    default ``torch.distributed`` group: process i holds ranks
    ``[i k, (i + 1) k)``, k = p / procs, this one ``proc``."""

    def __init__(self, p: int, procs: int, proc: int):
        self.p, self.procs, self.proc = p, procs, proc
        self.lo, self.hi = split_ranks(p, procs, proc)
        if not dist.is_initialized() or dist.get_world_size() != procs:
            raise RuntimeError(
                f"a {procs}-process view needs a live torch.distributed "
                f"group of {procs} processes "
                "(parallel.multihost.init_distributed)")

    def mine(self, seq) -> tuple:
        """A per-rank list over the p ranks, cut to this process's."""
        seq = tuple(seq)
        if len(seq) != self.p:
            raise ValueError(f"a per-rank list of {len(seq)} under a "
                             f"view of {self.p} ranks")
        return seq[self.lo:self.hi]

    def ppermute(self, a: torch.Tensor, perm) -> torch.Tensor:
        """``lax.ppermute`` on this process's rows: local pairs by one
        gather, remote ones as one send and one receive per peer
        process, ranks that receive nothing zero-filled."""
        return self.ppermute_group((a,), perm)[0]

    def ppermute_group(self, tensors, perm) -> list:
        """:meth:`ppermute` of each of ``tensors`` (each ``(k, ...)``)
        by one permutation, every remote block of all of them in one
        batch of sends and receives."""
        k = self.hi - self.lo
        for a in tensors:
            if a.shape[0] != k:
                raise ValueError(f"a (k={k}, ...) operand holds this "
                                 f"process's ranks; got {tuple(a.shape)}")
        ls, ld, sends, recvs, full = _proc_plan(
            tuple(map(tuple, perm)), self.p, k, self.proc)
        outs = []
        for a in tensors:
            out = a.new_empty(a.shape) if full else a.new_zeros(a.shape)
            if ls:
                out.index_copy_(0, index(ld, a.device),
                                a.index_select(0, index(ls, a.device)))
            outs.append(out)
        if not (sends or recvs):
            return outs
        ops, inbox = [], []
        for a in tensors:
            for q, rows in sends:
                buf = _to_wire(a.index_select(0, index(rows, a.device)))
                ops.append(dist.P2POp(dist.isend, buf, q))
                WIRE["bytes_sent"] += buf.numel()
        for a, out in zip(tensors, outs):
            for q, rows in recvs:
                buf = _wire_buffer((len(rows),) + a.shape[1:], a.dtype, a)
                ops.append(dist.P2POp(dist.irecv, buf, q))
                inbox.append((a, out, rows, buf))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        WIRE["messages"] += len(sends) * len(tensors)
        for a, out, rows, buf in inbox:
            WIRE["bytes_received"] += buf.numel()
            got = buf.view(a.dtype).view((len(rows),) + a.shape[1:])
            out.index_copy_(0, index(rows, a.device), got.to(a.device))
        return outs

    @staticmethod
    def _count(h: torch.Tensor) -> None:
        WIRE["collectives"] += 1
        WIRE["collective_bytes"] += h.numel() * h.element_size()

    def all_reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """``t`` reduced elementwise over the processes by the backend's
        own collective (the vendor baseline across processes)."""
        h = t.contiguous()
        h = h.cpu() if h.is_cuda else h.clone()
        self._count(h)
        dist.all_reduce(h, op=getattr(dist.ReduceOp, _REDUCE_OPS[op]))
        return h.to(t.device)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every process's ``t`` (this process's rows), concatenated in
        process order: the (p, ...) rows of the whole axis."""
        h = t.contiguous().cpu()
        self._count(h)
        parts = [torch.empty_like(h) for _ in range(self.procs)]
        dist.all_gather(parts, h)
        return torch.cat(parts).to(t.device)

    def broadcast(self, t: torch.Tensor, root: int) -> torch.Tensor:
        """``t`` as the process holding rank ``root`` has it, on every
        process, by the backend's broadcast (``t`` must have the same
        shape and dtype everywhere)."""
        h = t.contiguous()
        h = h.cpu() if h.is_cuda else h.clone()
        self._count(h)
        dist.broadcast(h, src=root // (self.hi - self.lo))
        return h.to(t.device)

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """The backend's all-to-all over processes: ``t`` is (procs,
        ...), slice q bound for process q; returns (procs, ...), slice
        q from process q."""
        h = t.contiguous().cpu()
        self._count(h)
        out = torch.empty_like(h)
        dist.all_to_all_single(out, h)
        return out.to(t.device)


class processes:
    """Install ``view`` for the duration of a run (re-entrant, as
    :class:`checked`); ``None`` installs nothing."""

    def __init__(self, view):
        self.view = view

    def __enter__(self):
        self._prev = process_view()
        if self.view is not None:
            _local.view = self.view
        return self.view

    def __exit__(self, *exc):
        _local.view = self._prev
        return False


class no_view:
    """Run with no process view installed (a dry run of a schedule on
    operands that hold every rank, as ``integrity.steps_of`` makes)."""

    def __enter__(self):
        self._prev = process_view()
        _local.view = None

    def __exit__(self, *exc):
        _local.view = self._prev
        return False


def mesh_view(mesh, axis: str):
    """The :class:`ProcessView` of ``mesh``'s ``axis`` (a flat
    ``RankMesh``), None when its ranks live in one process."""
    procs = getattr(mesh, "procs", 1)
    if procs == 1:
        return None
    if len(mesh.shape) != 1:
        raise NotImplementedError(
            "a flat schedule over one axis of a multi-process hybrid mesh "
            "is not ported yet (ROADMAP A5); its hierarchical collectives "
            "are")
    return ProcessView(mesh.shape[axis], procs, mesh.proc)


# -- the corruption site ----------------------------------------------
# (the fold, ``segment_checksum``, is ``ops.cuda_integrity``'s: the
# kernel on a CUDA tensor, its plain version on a CPU one; (p, ...) in,
# (p,) int32 holding each rank row's uint32 fold out)


def traced_flip(x: torch.Tensor, taint, call_idx: int,
                lo: int = 0) -> torch.Tensor:
    """The in-schedule corruption site (the device-side SDC drill).

    ``taint`` is int32 ``[step, rank, elem_seed, bit]`` on the host: when
    ``step == call_idx``, one bit (``bit`` mod the element's width) of
    element ``elem_seed`` mod the row's size in rank ``rank``'s row of
    ``x`` (row ``rank - lo``: ``x`` holds ranks from ``lo`` on) is
    flipped in place, as JAX's flips it on device ``rank``; bool
    payloads flip a bit of their uint8 view and read back as ``!= 0``,
    as JAX's. Otherwise ``x`` is returned untouched. ``x`` must be a
    new tensor (the received block), never a view of the sender's."""
    if taint is None or int(taint[0]) != call_idx:
        return x
    p = x.shape[0]
    row = x.numel() // p if p else 0
    rank = int(taint[1]) - lo
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
