"""Batch-level scheduling for the peg-solitaire workload: the
master/worker study on the card.

The port of ``icikit/models/solitaire/scheduler.py``. The reference's
farm (``Dynamic-Load-Balancing/src/main.cc``) is a pull model: rank 0
holds the game list; workers send ``work_need`` and receive 8-game
chunks (``:91-103``) until the list drains, so fast workers
automatically absorb more of the variable-cost DFS work. Here the host
is the master and a worker is a ``torch.device`` with a CUDA stream of
its own: ``devices`` may repeat one device, so 8 workers share the one
card as 8 streams (JAX gives each worker a device of its own; the
default here is one worker on the card). A chunk is a fixed-shape board
batch, one launch of the DFS kernel on the worker's stream.

Two strategies, so the imbalance study is measurable (the point of the
reference sub-repo, ``Dynamic-Load-Balancing/README.md:5``):

- ``solve_static``: each worker gets one equal contiguous slice up
  front (what MPI folklore calls block decomposition). Wall time is the
  unluckiest worker's total.
- ``solve_dynamic``: the pull model. A lock-protected cursor over
  fixed-size chunks; one host thread per worker plays the client loop
  (request chunk -> solve -> report), mirroring tags
  work_need/work_avail/terminate (``main.cc:16-20``) as plain control
  flow.

All chunks share one padded shape; padding boards are empty (zero pegs:
they exhaust in one DFS step and can never count as solutions, since a
win needs exactly one peg). The checkpoint's JSON-lines format and its
fingerprint are JAX's, so a file written by either package resumes in
the other.
"""

from __future__ import annotations

import collections
import hashlib
import json
import os
import threading
import time
import warnings
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from icikit_torch import chaos, obs

# site registry (chaos satellite): per-worker sites are a dynamic
# family, declared as the pattern the drills address
chaos.register_site("solitaire.worker.*", "solitaire.ckpt.write")

from icikit_torch.models.solitaire.game import (  # noqa: E402
    MAX_DEPTH,
    BoardBatch,
    render_board,
    render_solution,
    solve_batch,
)

DEFAULT_CHUNK = 8       # reference chunk_size (main.cc:15)
DEFAULT_LEASE_S = 120.0  # hung-worker reissue deadline per pull

_streams: dict = {}
_streams_lock = threading.Lock()


def _workers(devices) -> list:
    """The workers' devices: one on the card by default; a repeated
    device is one worker per entry."""
    if devices is None:
        return [torch.device("cuda")]
    return [torch.device(d) for d in devices]


def _stream(dev: torch.device, w: int):
    """Worker ``w``'s own CUDA stream on ``dev`` (made once, kept), or
    None on the CPU."""
    if dev.type != "cuda":
        return None
    key = (dev.index if dev.index is not None
           else torch.cuda.current_device(), w)
    with _streams_lock:
        if key not in _streams:
            _streams[key] = torch.cuda.Stream(device=key[0])
        return _streams[key]


# CPU workers take turns: the plain solver is a Python loop of small
# ops, and eight threads interleaving them contend for the interpreter
# lock (a pull took ten times as long as the same pull alone)
_cpu_turn = threading.Lock()


def _on(stream):
    """Make ``stream`` current for this thread; on the CPU (None), hold
    the CPU workers' turn."""
    return (torch.cuda.stream(stream) if stream is not None
            else _cpu_turn)


def _to_device(masks: np.ndarray, dev: torch.device) -> torch.Tensor:
    """uint32 masks as a uint32 tensor on ``dev``, copied on the current
    stream."""
    t = torch.from_numpy(np.ascontiguousarray(masks, np.uint32)
                         .view(np.int32))
    return t.to(dev).view(torch.uint32)


def _wait(stream) -> None:
    if stream is not None:
        stream.synchronize()


def _to_host(out) -> tuple:
    """A solve_batch result as JAX's numpy arrays (bool, int32 x4)."""
    return tuple(o.cpu().numpy() for o in out)


class NoSurvivorsError(RuntimeError):
    """Every dynamic-schedule worker died before the queue drained.

    Raised *promptly* — as soon as the last worker dies, not after a
    join over threads that may never return — and only then: any
    surviving worker absorbs the dead workers' chunks instead
    (SURVEY.md §5.3's fail-fast story upgraded to self-healing).
    ``deaths`` maps worker index -> the exception that killed it.
    """

    def __init__(self, msg: str, deaths: dict):
        super().__init__(msg)
        self.deaths = dict(deaths)


@dataclass
class SolveReport:
    """Results + scheduling telemetry for one solve run."""

    solved: np.ndarray    # bool[B]
    n_moves: np.ndarray   # int32[B]
    moves: np.ndarray     # int32[B, MAX_DEPTH]
    steps: np.ndarray     # int32[B] DFS nodes per board (cost signal)
    status: np.ndarray    # int32[B]
    wall_s: float
    strategy: str
    chunk_size: int
    per_worker_games: list = field(default_factory=list)
    per_worker_steps: list = field(default_factory=list)
    n_pulls: int = 0      # dynamic only: queue pulls (= host barriers)
    # self-healing telemetry (dynamic only): how many workers died, how
    # many leased chunks were handed back out after a death or an
    # expired lease, and which worker indices died
    n_deaths: int = 0
    n_reissues: int = 0
    worker_deaths: list = field(default_factory=list)
    # repr() of the exception that killed each worker, aligned with
    # worker_deaths — survivors absorbing a death must not make the
    # underlying error (a real bug, an OOM, an injected drill) invisible
    death_errors: list = field(default_factory=list)

    @property
    def n_solutions(self) -> int:
        return int(self.solved.sum())

    @property
    def imbalance(self) -> float:
        """max/mean of per-worker DFS-node totals; 1.0 = perfectly
        balanced. The quantity dynamic scheduling exists to shrink."""
        s = np.asarray(self.per_worker_steps, dtype=np.float64)
        if s.size == 0 or s.mean() == 0:
            return 1.0
        return float(s.max() / s.mean())


def _pad(batch: BoardBatch, to: int) -> BoardBatch:
    pad = to - len(batch)
    if pad <= 0:
        return batch
    return BoardBatch(
        pegs=np.concatenate([batch.pegs, np.zeros(pad, np.uint32)]),
        playable=np.concatenate([batch.playable, np.zeros(pad, np.uint32)]))


class ChunkCheckpoint:
    """Resumable per-chunk result store for the dynamic scheduler.

    The reference survived crashes only by accident — the server streamed
    client solutions to the output file as they arrived
    (``Dynamic-Load-Balancing/src/main.cc:104-106``; SURVEY.md §5.4),
    but a restart re-solved everything. This makes resume deliberate:
    each completed chunk is appended as one JSON line (with flush) so a
    killed run loses at most the chunks in flight; a restart loads the
    file and only solves what is missing. A dataset/config fingerprint
    in the header refuses to resume onto different work.

    Robustness contract (the chaos drills exercise all three):

    - a corrupt-but-parseable record (bit-flipped on disk into wrong
      lengths, dtypes, or a bogus chunk index) is *skipped* like a torn
      tail — the chunk is simply re-solved — instead of crashing the
      post-join ``np.concatenate``;
    - duplicate records for one chunk (reissue writes from a revived
      worker) are explicit last-writer-wins on load, and harmless by
      construction: the solver is deterministic, so every record for a
      chunk holds identical arrays;
    - ``add`` retries transient I/O failures with bounded backoff
      before letting the error surface as a worker death;
    - ``close()`` seals the store: a hung worker thread abandoned by
      ``solve_dynamic``'s bounded join may wake *after* the run
      returned — and after the caller reused the path for different
      work — so late ``add`` calls on a sealed store are dropped
      instead of appended.
    """

    _FIELDS = ("solved", "n_moves", "moves", "steps", "status")
    _DTYPES = (bool, np.int32, np.int32, np.int32, np.int32)

    def __init__(self, path, fingerprint: str, chunk_size: int = None):
        self.path = Path(path)
        self.fingerprint = fingerprint
        self.chunk_size = chunk_size
        self._lock = threading.Lock()
        self._closed = False
        self.loaded: dict[int, tuple] = {}
        self.n_skipped = 0  # invalid records dropped on load
        if self.path.exists() and self.path.stat().st_size > 0:
            with open(self.path) as f:
                header = json.loads(f.readline())
                if header.get("fingerprint") != fingerprint:
                    raise ValueError(
                        f"checkpoint {path} was written for a different "
                        "dataset/configuration; refusing to resume")
                for line in f:
                    if not line.strip():
                        continue  # torn tail line from a crash mid-write
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    parsed = self._validate(rec)
                    if parsed is None:
                        self.n_skipped += 1
                        continue
                    # duplicate chunk records (reissue writes) are
                    # last-writer-wins: later lines overwrite earlier
                    self.loaded[rec["chunk"]] = parsed
        else:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            with open(self.path, "w") as f:
                f.write(json.dumps({"fingerprint": fingerprint}) + "\n")

    def _validate(self, rec) -> tuple | None:
        """Parse one record into the result-array tuple, or None when
        anything about it fails the chunk shape/dtype contract."""
        try:
            c = rec["chunk"]
            if not isinstance(c, int) or isinstance(c, bool) or c < 0:
                return None
            arrays = tuple(np.asarray(rec[k], dtype=d)
                           for k, d in zip(self._FIELDS, self._DTYPES))
        except (KeyError, TypeError, ValueError, OverflowError):
            return None
        solved, n_moves, moves, steps, status = arrays
        n = self.chunk_size if self.chunk_size is not None else len(solved)
        if any(a.shape != (n,) for a in (solved, n_moves, steps, status)):
            return None
        if moves.shape != (n, MAX_DEPTH):
            return None
        return arrays

    def add(self, chunk: int, arrays: tuple, retries: int = 3) -> None:
        rec = {"chunk": chunk}
        for k, a in zip(self._FIELDS, arrays):
            rec[k] = np.asarray(a).tolist()
        line = json.dumps(rec) + "\n"

        def write():
            with self._lock:
                if self._closed:
                    return  # stale straggler from a finished run
                with open(self.path, "a") as f:
                    f.write(line)
                    f.flush()
                    os.fsync(f.fileno())

        chaos.io_retry("solitaire.ckpt.write", write, retries=retries,
                       first_backoff=0.01)

    def close(self) -> None:
        """Seal the store; subsequent ``add`` calls are no-ops."""
        with self._lock:
            self._closed = True


def checkpoint_fingerprint(batch: BoardBatch, chunk_size: int,
                           max_steps: int) -> str:
    """Content hash binding a checkpoint to its dataset and solve
    configuration."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(batch.pegs).tobytes())
    h.update(np.ascontiguousarray(batch.playable).tobytes())
    h.update(f"{chunk_size}:{max_steps}".encode())
    return h.hexdigest()


def solve_static(batch: BoardBatch, devices=None,
                 max_steps: int = 2_000_000_000) -> SolveReport:
    """Equal up-front split: worker d gets the d-th contiguous slice.

    One async launch per worker, each on its own stream, then a single
    barrier — the launches overlap, so wall time = slowest worker,
    exactly the static-schedule cost model.
    """
    devices = _workers(devices)
    n = len(batch)
    p = max(1, min(len(devices), n))
    per = -(-n // p)  # ceil
    padded = _pad(batch, per * p)

    outs = []
    t0 = time.perf_counter()
    with obs.span("solve.static", n=n, p=p, per=per):
        streams = [_stream(devices[d], d) for d in range(p)]
        for d in range(p):
            sl = slice(d * per, (d + 1) * per)
            with _on(streams[d]):
                pg = _to_device(padded.pegs[sl], devices[d])
                pl = _to_device(padded.playable[sl], devices[d])
                outs.append(solve_batch(pg, pl, max_steps))
        for st in streams:
            _wait(st)
    wall = time.perf_counter() - t0

    parts = []
    for d, out in enumerate(outs):
        with _on(streams[d]):
            parts.append(_to_host(out))
    solved = np.concatenate([pt[0] for pt in parts])[:n]
    n_moves = np.concatenate([pt[1] for pt in parts])[:n]
    moves = np.concatenate([pt[2] for pt in parts])[:n]
    steps = np.concatenate([pt[3] for pt in parts])[:n]
    status = np.concatenate([pt[4] for pt in parts])[:n]

    per_games, per_steps = [], []
    for d in range(p):
        real = min(per, max(0, n - d * per))
        per_games.append(real)
        per_steps.append(int(parts[d][3][:real].sum()))
    return SolveReport(solved=solved, n_moves=n_moves, moves=moves,
                       steps=steps, status=status, wall_s=wall,
                       strategy="static", chunk_size=per,
                       per_worker_games=per_games,
                       per_worker_steps=per_steps)


class _LeaseQueue:
    """Chunk work queue with per-chunk leases — the self-healing core.

    ``claim`` hands out chunks under a lease ``(worker, deadline)``;
    ``commit`` retires them. A worker death (``mark_dead``) releases its
    leased chunks back to the queue head for survivors; a lease that
    outlives its deadline (hung worker) is reaped and reissued the same
    way. A revived worker's late commit is idempotent: the first commit
    wins the telemetry, and the *results* are identical either way
    because the solver is deterministic. Invariant: every chunk is in
    exactly one of todo / leased / done, so ``todo and leases both
    empty`` == drained.
    """

    def __init__(self, chunks, lease_s: float, n_workers: int):
        self._todo = collections.deque(chunks)
        self._leases: dict = {}     # chunk -> (worker, deadline)
        self._done: set = set()
        self._cv = threading.Condition()
        self.lease_s = lease_s
        self.n_workers = n_workers
        self.n_total = len(chunks)
        self.deaths: dict = {}      # worker -> exception
        self.reissues = 0
        self.pulls = 0
        self.per_games = [0] * n_workers
        self.per_steps = [0] * n_workers

    # -- worker side -------------------------------------------------

    def claim(self, worker: int, p: int, max_pull: int) -> list:
        """Guided pull: ~(todo / 2p) chunks, in [1, max_pull]; empty
        list means the run is over for this worker. Blocks while the
        queue is empty but chunks are still leased out — those may come
        back (death, expired lease) and someone must be left to take
        them."""
        while True:
            expired, out = (), None
            with self._cv:
                if len(self._done) == self.n_total:
                    out = []
                else:
                    expired = self._reap_expired()
                    if self._todo:
                        remaining = len(self._todo)
                        k = max(1, min(remaining // (2 * p), max_pull))
                        k = min(k, remaining)
                        out = [self._todo.popleft() for _ in range(k)]
                        deadline = time.monotonic() + self.lease_s
                        for c in out:
                            self._leases[c] = (worker, deadline)
                        self.pulls += 1
                    elif not self._leases:
                        out = []  # drained (terminate tag, main.cc:93-97)
                    else:
                        self._cv.wait(min(0.05, self.lease_s / 4))
            self._emit_expired(expired)
            if out is not None:
                return out

    def commit(self, worker: int, chunk: int, games: int,
               steps: int) -> bool:
        """Retire a solved chunk; returns True on the first commit
        (duplicates from reissued work change nothing)."""
        with self._cv:
            self._leases.pop(chunk, None)
            dup = chunk in self._done
            if not dup:
                # a straggler may commit after its expired lease
                # already bounced the chunk back to the queue — pull it
                # out so no survivor re-solves finished work
                # (todo/leased/done stay mutually exclusive)
                try:
                    self._todo.remove(chunk)
                except ValueError:
                    pass
                self._done.add(chunk)
                self.per_games[worker] += games
                self.per_steps[worker] += steps
                self._cv.notify_all()
        if dup:
            obs.emit("scheduler.duplicate_commit", worker=worker,
                     chunk=chunk)
        return not dup

    def mark_dead(self, worker: int, exc: BaseException) -> None:
        """Record a worker death and hand its leased chunks back."""
        with self._cv:
            self.deaths[worker] = exc
            freed = [c for c, (w, _) in self._leases.items() if w == worker]
            for c in freed:
                del self._leases[c]
                self._todo.appendleft(c)
            self.reissues += len(freed)
            self._cv.notify_all()
        # bus + metrics outside the lock: a slow sink must never stall
        # the queue (or deadlock a sink that itself reads queue state)
        obs.emit("scheduler.worker_death", worker=worker,
                 error=repr(exc), reissued_chunks=freed)
        obs.count("scheduler.deaths")
        obs.count("scheduler.reissues", len(freed))
        obs.instant("scheduler.worker_death", worker=worker)

    def _reap_expired(self) -> list:
        # caller holds the lock; returns the reaped chunks so the
        # caller can _emit_expired them AFTER releasing it
        now = time.monotonic()
        expired = [c for c, (_, dl) in self._leases.items() if dl <= now]
        for c in expired:
            del self._leases[c]
            self._todo.appendleft(c)
        self.reissues += len(expired)
        return expired

    def _emit_expired(self, expired) -> None:
        # bus + metrics outside the lock (the mark_dead discipline):
        # a slow sink must never stall the queue
        if expired:
            obs.emit("scheduler.lease_expired", chunks=list(expired))
            obs.count("scheduler.lease_expired", len(expired))
            obs.count("scheduler.reissues", len(expired))

    # -- monitor side ------------------------------------------------

    def wait_drained(self) -> None:
        """Block until every chunk is committed; raise NoSurvivorsError
        the moment the last worker dies with work outstanding."""
        while True:
            expired = ()
            with self._cv:
                if len(self._done) >= self.n_total:
                    return
                if len(self.deaths) >= self.n_workers:
                    deaths = {w: e for w, e in sorted(self.deaths.items())}
                    msg = ("solve_dynamic: all "
                           f"{self.n_workers} workers died with "
                           f"{self.n_total - len(self._done)} of "
                           f"{self.n_total} chunks uncommitted "
                           f"(reissues={self.reissues}); deaths: "
                           + "; ".join(f"worker {w}: {e!r}"
                                       for w, e in deaths.items()))
                    raise NoSurvivorsError(msg, deaths) \
                        from next(iter(deaths.values()))
                expired = self._reap_expired()
                self._cv.wait(0.05)
            self._emit_expired(expired)


def solve_dynamic(batch: BoardBatch, devices=None,
                  chunk_size: int = DEFAULT_CHUNK,
                  max_steps: int = 2_000_000_000,
                  checkpoint_path=None,
                  max_pull: int = 32,
                  lease_s: float = DEFAULT_LEASE_S) -> SolveReport:
    """Pull-model dynamic schedule: a shared cursor over fixed-size
    chunks; one host thread per device requests, solves, and reports
    until the queue drains (reference client loop, ``main.cc:146-191``,
    with the Iprobe/tag protocol collapsed into thread-safe control
    flow — there is no message to probe for when master and workers
    share an address space).

    Each pull takes a *guided* run of chunks — half the remaining queue
    split across workers, capped at ``max_pull``, never below 1 — and
    launches them asynchronously on the worker's stream before one
    barrier, so a worker pays one host<->device round trip per pull
    instead of per chunk (guided pulls amortize it over up to
    ``max_pull`` chunks early on while the final pulls shrink back to
    single chunks for tail balance — classic guided self-scheduling).
    Every chunk keeps the same padded shape.

    ``checkpoint_path``: persist each completed chunk and skip chunks
    already recorded there on restart (see ``ChunkCheckpoint``).

    Self-healing (the chaos drills' target): chunks are handed out
    under leases (``lease_s`` deadline per pull). A crashed worker's
    in-flight chunks are reissued to survivors immediately; a hung
    worker's are reissued when its lease expires (its late duplicate
    commits are idempotent). The run only fails — promptly, with
    per-worker death telemetry — when *zero* workers survive
    (:class:`NoSurvivorsError`). Death and reissue counts surface in
    the report (``n_deaths``, ``n_reissues``, ``worker_deaths``,
    ``death_errors``), and a healed run emits a ``RuntimeWarning``
    naming each dead worker's exception."""
    devices = _workers(devices)
    n = len(batch)
    n_chunks = -(-n // chunk_size) if n else 0
    padded = _pad(batch, n_chunks * chunk_size)
    p = max(1, min(len(devices), max(n_chunks, 1)))

    ckpt = None
    results: list = [None] * n_chunks
    pending = list(range(n_chunks))
    if checkpoint_path is not None:
        ckpt = ChunkCheckpoint(
            checkpoint_path,
            checkpoint_fingerprint(batch, chunk_size, max_steps),
            chunk_size=chunk_size)
        for i, arrays in ckpt.loaded.items():
            if i < n_chunks:
                results[i] = arrays
        pending = [i for i in pending if results[i] is None]

    queue = _LeaseQueue(pending, lease_s, p)

    def worker(w: int):
        dev = devices[w]
        stream = _stream(dev, w)
        site = f"solitaire.worker.{w}"
        try:
            # worker-lifetime span on this thread's timeline: the gaps
            # between its pull spans ARE the straggler/imbalance story
            # the DLB study exists to show
            with obs.span("solve.worker", worker=w):
                while True:
                    chunks = queue.claim(w, p, max_pull)
                    # crash drill: probed on every pull, including the
                    # terminal empty one, so a scheduled first-pull
                    # death fires deterministically even when a fast
                    # peer drained the queue before this thread got a
                    # chunk
                    chaos.maybe_die(site)
                    if not chunks:
                        return
                    chaos.maybe_delay(site)  # straggler / hang drill
                    with obs.span("solve.pull", worker=w,
                                  n_chunks=len(chunks)), _on(stream):
                        # the pull's boards in one copy (a copy from
                        # pageable memory waits for the stream), then
                        # async launches a chunk, one barrier per pull
                        rows = np.concatenate([
                            np.arange(i * chunk_size, (i + 1) * chunk_size)
                            for i in chunks])
                        pg = _to_device(padded.pegs[rows], dev)
                        pl = _to_device(padded.playable[rows], dev)
                        outs = []
                        for k, i in enumerate(chunks):
                            sl = slice(k * chunk_size, (k + 1) * chunk_size)
                            with obs.span("solve.chunk", chunk=i,
                                          worker=w):
                                outs.append((i, solve_batch(
                                    pg[sl], pl[sl], max_steps)))
                        _wait(stream)
                        for i, out in outs:
                            arrays = _to_host(out)
                            results[i] = arrays
                            # durable record first, then retire the
                            # lease: an I/O death here leaves the chunk
                            # leased, so it reissues like any other
                            # crash
                            if ckpt is not None:
                                ckpt.add(i, arrays)
                            real = min(chunk_size,
                                       max(0, n - i * chunk_size))
                            queue.commit(w, i, real,
                                         int(arrays[3][:real].sum()))
                            obs.count("scheduler.commits")
        except BaseException as e:  # a dead worker, not a dead farm
            queue.mark_dead(w, e)

    t0 = time.perf_counter()
    if pending:
        with obs.span("solve.dynamic", n_chunks=n_chunks, p=p,
                      chunk_size=chunk_size, pending=len(pending)):
            threads = [threading.Thread(target=worker, args=(w,),
                                        daemon=True)
                       for w in range(p)]
            for t in threads:
                t.start()
            queue.wait_drained()
            # survivors exit on their own (claim returns empty once
            # done); hung stragglers are daemons whose late commits are
            # idempotent, so completed work is never held hostage to
            # their join
            for t in threads:
                t.join(timeout=1.0)
    if ckpt is not None:
        # an abandoned straggler waking after this return must not
        # append a record computed from THIS dataset to a file the
        # caller may have rewritten for different work
        ckpt.close()
    wall = time.perf_counter() - t0

    # register the healing counters even on a clean run ("0 reissues"
    # is telemetry; a missing key is a blind spot) and publish the
    # run's scheduling summary on the bus
    obs.count("scheduler.reissues", 0)
    obs.count("scheduler.deaths", 0)
    obs.count("scheduler.lease_expired", 0)
    obs.count("scheduler.pulls", queue.pulls)
    if obs.enabled():
        obs.emit("scheduler.drained", strategy="dynamic",
                 n_chunks=n_chunks, pulls=queue.pulls,
                 deaths=len(queue.deaths), reissues=queue.reissues,
                 wall_s=round(wall, 4))

    if queue.deaths:
        # the run healed, but the errors that killed workers must stay
        # visible — a genuine bug absorbed by reissue would otherwise
        # masquerade as successful self-healing forever
        warnings.warn(
            f"solve_dynamic: {len(queue.deaths)} of {p} workers died; "
            f"{queue.reissues} leased chunks were reissued to "
            "survivors; deaths: "
            + "; ".join(f"worker {w}: {e!r}"
                        for w, e in sorted(queue.deaths.items())),
            RuntimeWarning, stacklevel=2)

    if n_chunks:
        solved = np.concatenate([r[0] for r in results])[:n]
        n_moves = np.concatenate([r[1] for r in results])[:n]
        moves = np.concatenate([r[2] for r in results])[:n]
        steps = np.concatenate([r[3] for r in results])[:n]
        status = np.concatenate([r[4] for r in results])[:n]
    else:
        solved = np.zeros(0, bool)
        n_moves = steps = status = np.zeros(0, np.int32)
        moves = np.zeros((0, MAX_DEPTH), np.int32)
    return SolveReport(solved=solved, n_moves=n_moves, moves=moves,
                       steps=steps, status=status, wall_s=wall,
                       strategy="dynamic", chunk_size=chunk_size,
                       per_worker_games=queue.per_games,
                       per_worker_steps=queue.per_steps,
                       n_pulls=queue.pulls,
                       n_deaths=len(queue.deaths),
                       n_reissues=queue.reissues,
                       worker_deaths=sorted(queue.deaths),
                       death_errors=[repr(queue.deaths[w])
                                     for w in sorted(queue.deaths)])


def simulate_schedule(steps: np.ndarray, p: int, strategy: str,
                      chunk_size: int = DEFAULT_CHUNK,
                      max_pull: int = 32) -> list[int]:
    """Per-worker DFS-step totals under an idealized ``p``-worker run.

    The imbalance *study* needs schedule quality, not thread-race
    noise: on a host with fewer cores than workers (CI, this repo's
    1-core container) the live threads timeshare, so their per-worker
    telemetry reflects the OS scheduler, not the algorithm. Here the
    measured per-board costs (DFS node counts — exact, deterministic)
    replay through a virtual clock instead:

    - ``static``: contiguous ceil(n/p) slices, the block decomposition
      (``solve_static``).
    - ``dynamic``: the *shipped* pull model including guided
      multi-chunk pulls — at each pull the least-loaded (virtual-time)
      worker takes ``max(1, min(remaining // 2p, max_pull))`` chunks,
      exactly ``solve_dynamic``'s policy with dispatch latency taken
      to zero (reference ``main.cc:91-103``).

    Returns the per-worker totals; ``max/mean`` is the imbalance and
    ``max`` the modeled critical path (wall time on ideal hardware).
    """
    import heapq
    steps = np.asarray(steps, dtype=np.int64)
    n = len(steps)
    if strategy == "static":
        per = -(-n // p)
        return [int(steps[w * per:(w + 1) * per].sum()) for w in range(p)]
    if strategy != "dynamic":
        raise ValueError(f"unknown strategy {strategy!r}")
    n_chunks = -(-n // chunk_size) if n else 0
    clock = [(0, w) for w in range(p)]
    heapq.heapify(clock)
    totals = [0] * p
    c = 0
    while c < n_chunks:
        k = max(1, min((n_chunks - c) // (2 * p), max_pull))
        cost = int(steps[c * chunk_size:(c + k) * chunk_size].sum())
        t, w = heapq.heappop(clock)
        totals[w] += cost
        heapq.heappush(clock, (t + cost, w))
        c += k
    return totals


def solve_host(batch: BoardBatch, n_threads: int = 0,
               chunk_size: int = DEFAULT_CHUNK,
               max_steps: int = 2_000_000_000) -> SolveReport:
    """Native host backend: the C++ DFS solver behind a C++ thread-pool
    work queue (``icikit_torch/native/src/solver.cc``). This is the role
    the reference's whole program played — native workers pulling
    chunks — kept as a first-class backend so the study can compare the
    host's threads with the card's kernel (SURVEY.md §5.8)."""
    from icikit_torch import native

    # resolve through the same rule solve_batch applies internally, so
    # the per_games/per_steps domains below always match the worker
    # ids the pool reports (on the serial Python fallback this is ONE
    # worker — the telemetry describes the run that actually happened;
    # a fabricated n-thread split would publish imbalance = n_threads
    # for both strategies)
    n_threads = native.resolve_n_threads(n_threads)
    t0 = time.perf_counter()
    solved, n_moves, moves, steps, workers = native.solve_batch(
        batch.pegs, batch.playable, max_steps=max_steps,
        n_threads=n_threads, chunk_size=chunk_size, return_workers=True)
    wall = time.perf_counter() - t0
    status = np.where(solved, 1, np.where(steps >= max_steps, 3, 2))
    # Per-worker telemetry from the pool's board→worker map: which
    # thread solved each board, so the live queue's load split is
    # directly comparable to simulate_schedule's virtual-clock replay.
    per_games = [int((workers == w).sum()) for w in range(n_threads)]
    per_steps = [int(steps[workers == w].sum()) for w in range(n_threads)]
    return SolveReport(solved=solved, n_moves=n_moves, moves=moves,
                       steps=steps.astype(np.int64), status=status,
                       wall_s=wall, strategy="host", chunk_size=chunk_size,
                       per_worker_games=per_games,
                       per_worker_steps=per_steps)


def write_solutions(path, batch: BoardBatch, report: SolveReport) -> int:
    """Write every solved game's move-sequence rendering (board states
    joined by '-->') to ``path``, then return the solution count — the
    server's output-file + "found N solutions" behavior
    (``main.cc:104-106``, ``:135``). Unlike the reference, server-solved
    and client-solved games are treated identically (the reference only
    wrote client solutions — SURVEY.md §2 defect 3)."""
    count = 0
    with open(path, "w") as f:
        for b in range(len(batch)):
            if not report.solved[b]:
                continue
            board = render_board(int(batch.pegs[b]), int(batch.playable[b]))
            ms = report.moves[b][:int(report.n_moves[b])]
            f.write(render_solution(board, ms))
            f.write("\n")
            count += 1
    return count
