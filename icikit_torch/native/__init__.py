"""ctypes binding for the port's native runtime (``libicikit_torch.so``).

The port keeps its own copy of ``icikit/native``'s C++ sources
(``icikit_torch/native/src/``) and builds them lazily on first use
(``make -C icikit_torch/native``) into ``build/``, under its own
``flock``. The library has a name of its own, so both packages' runtimes
can load in one process. Every entry point has a pure-Python fallback,
so the port degrades gracefully on hosts without a toolchain.
``available()`` reports which path is active; the CPU tests and
``chip_smoke.py`` assert the native path.

Native pieces (reference counterparts in parentheses):
- ``install_traps``/``watchdog`` — crash containment + runaway-job alarm
  (``chopsigs_``, ``utilities.cc:49-58``);
- ``monotonic_s`` — monotonic clock (``get_timer``'s ``MPI_Wtime``);
- ``parse_boards`` — reference-format dataset parser (``main.cc:49-66``);
- ``solve``/``solve_batch`` — host DFS solver + threaded work-queue
  batch entry (``game.cc:121-138`` + the ``Server``/``Client`` farm);
- ``markov_fill`` — the trainer's data loader: threaded synthetic-corpus
  generation, bit-identical to the numpy fallback (the reference's
  p-invariant input generation, ``psort.cc:575-614``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_HERE, "build")
_LIB_PATH = os.path.join(BUILD_DIR, "libicikit_torch.so")
LOCK_PATH = os.path.join(BUILD_DIR, ".build.lock")

_lock = threading.Lock()
_lib = None
_build_error: str | None = None
MAX_DEPTH = 25


def _run_make_locked() -> str | None:
    """Run the lazy build under an exclusive ``flock`` on a sentinel
    file, so two processes first-loading concurrently serialize on the
    link step instead of one of them dlopen-ing a partially-written
    ``.so``. Returns an error string, or None on success. The lock file
    lives next to the library, in ``build/`` — same filesystem, so
    flock semantics hold wherever the build writes."""
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        lock_f = open(LOCK_PATH, "w")
    except OSError:
        lock_f = None  # read-only install: fall through unlocked
    try:
        if lock_f is not None:
            try:
                import fcntl
                fcntl.flock(lock_f, fcntl.LOCK_EX)
            except (ImportError, OSError):
                pass  # non-POSIX: best effort, identical to pre-lock
        try:
            subprocess.run(
                ["make", "-C", _HERE, "-s"], check=True,
                capture_output=True, text=True, timeout=120)
        except (subprocess.SubprocessError, OSError) as e:
            out = getattr(e, "stderr", "") or str(e)
            return f"native build failed: {out.strip()[:500]}"
        return None
    finally:
        if lock_f is not None:
            lock_f.close()  # closing drops the flock


def _try_load():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        # Always run make BEFORE the first dlopen: make's own mtime
        # check makes this a no-op when the library is current, and it
        # refreshes a stale prebuilt one from before newer sources.
        # Rebuilding after a SUCCESSFUL CDLL cannot work — glibc
        # dlopen returns the already-mapped handle for the same path,
        # so a post-load rebuild would never be picked up this
        # process. A FAILED CDLL maps nothing, so one retry after a
        # re-make is sound — it covers the racing-writer case the
        # flock closes for new processes but cannot retroactively fix
        # for a probe that read a torn file mid-replace.
        build_err = _run_make_locked()
        if build_err is not None and not os.path.exists(_LIB_PATH):
            _build_error = build_err
            return None
        # reaching here with build_err set = no toolchain but a
        # prebuilt library exists: try it (the symbol probe below
        # rejects it if too old)
        lib = None
        for attempt in (0, 1):
            try:
                lib = ctypes.CDLL(_LIB_PATH)
                break
            except OSError as e:
                if attempt == 1:
                    _build_error = f"native load failed: {e}"
                    return None
                # serialize behind any in-flight writer, rebuild if
                # the artifact is torn, then retry the load once
                _run_make_locked()
        if not (hasattr(lib, "ik_markov_fill")
                and hasattr(lib, "ik_solve_batch_w")):
            # stale prebuilt library and no working toolchain to
            # refresh it (make above would have): honest fallback
            _build_error = ("native library predates required entry "
                            "points and could not be rebuilt")
            return None
        try:
            lib.ik_install_traps.restype = ctypes.c_int
            lib.ik_restore_traps.restype = ctypes.c_int
            lib.ik_watchdog.argtypes = [ctypes.c_uint]
            lib.ik_trap_count.restype = ctypes.c_int
            lib.ik_watchdog_soft.argtypes = [ctypes.c_int]
            lib.ik_monotonic_s.restype = ctypes.c_double
            lib.ik_monotonic_ns.restype = ctypes.c_int64
            lib.ik_parse_boards.restype = ctypes.c_int64
            lib.ik_parse_boards.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.c_int64]
            lib.ik_solve.restype = ctypes.c_int
            lib.ik_solve.argtypes = [
                ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int64)]
            lib.ik_solve_batch_w.restype = ctypes.c_int
            lib.ik_solve_batch_w.argtypes = [
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int32)]  # board_worker (r5)
            lib.ik_markov_fill.restype = ctypes.c_int
            lib.ik_markov_fill.argtypes = [
                ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64,
                ctypes.c_uint64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int, ctypes.POINTER(ctypes.c_int32)]
        except AttributeError as e:
            # a future stale-library case the hasattr probe missed
            _build_error = f"native library missing symbol: {e}"
            return None
        _lib = lib
        return _lib


def available() -> bool:
    """True iff the native library is loaded (building it if needed)."""
    return _try_load() is not None


def build_error() -> str | None:
    """The reason the native path is unavailable, if it is."""
    _try_load()
    return _build_error


def install_traps() -> bool:
    """Install fatal-signal traps; False if only the Python fallback
    (which covers SIGALRM via the signal module, not SIGSEGV) applied."""
    lib = _try_load()
    if lib is not None:
        return lib.ik_install_traps() == 0
    return False


def restore_traps() -> bool:
    """Restore default signal dispositions (undo install_traps): a
    disarmed process must behave like an untouched one — the trap
    handler hard-exits with code 2, which turns benign teardown-time
    signals into truncated-output deaths."""
    lib = _try_load()
    if lib is not None:
        return lib.ik_restore_traps() == 0
    # no native traps were ever installed on this path; the Python
    # SIGALRM fallback is owned (saved + restored) by guard.chopsigs/
    # guard.disarm — nothing to undo here
    return True


def watchdog(seconds: int) -> None:
    """Arm the runaway-job alarm; 0 disarms."""
    lib = _try_load()
    if lib is not None:
        lib.ik_watchdog(int(seconds))
    else:
        import signal
        signal.alarm(int(seconds))


def watchdog_soft(enable: bool) -> None:
    lib = _try_load()
    if lib is not None:
        lib.ik_watchdog_soft(1 if enable else 0)


def trap_count() -> int:
    lib = _try_load()
    return lib.ik_trap_count() if lib is not None else 0


def monotonic_s() -> float:
    lib = _try_load()
    if lib is not None:
        return float(lib.ik_monotonic_s())
    import time
    return time.monotonic()


def parse_boards(text: bytes) -> tuple[np.ndarray, np.ndarray]:
    """Parse reference-format dataset bytes -> (pegs, playable) uint32
    arrays. Falls back to the Python parser when native is unavailable."""
    if isinstance(text, str):
        text = text.encode()
    lib = _try_load()
    if lib is None:
        from icikit_torch.models.solitaire.game import BoardBatch
        tokens = text.decode().split()
        if not tokens or not tokens[0].isdigit():
            raise ValueError("dataset parse error: bad header")
        n = int(tokens[0])
        if len(tokens) - 1 < n:
            raise ValueError(
                "dataset parse error: fewer rows than header promises")
        b = BoardBatch.from_strings(tokens[1:n + 1])
        return b.pegs, b.playable
    # Capacity from the header without a full parse: first token.
    head = text.split(None, 1)[0] if text.split() else b""
    try:
        cap = int(head)
    except ValueError:
        raise ValueError("dataset parse error: bad header") from None
    pegs = np.zeros(max(cap, 1), np.uint32)
    playable = np.zeros(max(cap, 1), np.uint32)
    n = lib.ik_parse_boards(
        text, len(text),
        pegs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        playable.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), cap)
    if n < 0:
        reasons = {-1: "bad header", -2: "bad board row",
                   -3: "fewer rows than header promises",
                   -4: "capacity too small"}
        raise ValueError(
            f"dataset parse error: {reasons.get(int(n), f'code {n}')}")
    return pegs[:n], playable[:n]


def solve(pegs: int, playable: int,
          max_steps: int = 2**62) -> tuple[bool, list[int], int]:
    """Native single-board DFS; returns (solved, moves, steps). Falls
    back to the Python oracle."""
    lib = _try_load()
    if lib is None:
        from icikit_torch.models.solitaire.game import solve_one_py
        return solve_one_py(pegs, playable)
    n_moves = ctypes.c_int32(0)
    steps = ctypes.c_int64(0)
    moves = (ctypes.c_int32 * MAX_DEPTH)()
    st = lib.ik_solve(pegs, playable, max_steps,
                      ctypes.byref(n_moves), moves, ctypes.byref(steps))
    return st == 1, list(moves[:n_moves.value]), int(steps.value)


def resolve_n_threads(n_threads: int = 0) -> int:
    """The worker count ``solve_batch`` will actually use for this
    request: explicit positive counts pass through; ``<= 0`` resolves
    to the host's logical CPUs on the native path (``solver.cc``'s
    ``hardware_concurrency`` rule) and to 1 on the serial Python
    fallback. Callers building per-worker telemetry
    (``scheduler.solve_host``) get the worker-id domain from here
    instead of re-deriving it."""
    if n_threads > 0:
        return n_threads
    return (os.cpu_count() or 1) if available() else 1


def solve_batch(pegs: np.ndarray, playable: np.ndarray,
                max_steps: int = 2**62, n_threads: int = 0,
                chunk_size: int = 8, return_workers: bool = False):
    """Native threaded work-queue batch solve. Returns (solved bool[B],
    n_moves int32[B], moves int32[B,25], steps int64[B]); with
    ``return_workers`` also int32[B] of the pool worker that solved
    each board (0 = the server thread) — the DLB study's per-worker
    telemetry. The Python fallback solves serially: worker 0.

    ``n_threads <= 0`` is resolved HERE (to the host's logical CPU
    count — mirroring ``solver.cc``'s ``hardware_concurrency``
    resolution) rather than passed through opaquely, so the returned
    worker-id domain is always known to the caller: with
    ``return_workers`` the ids lie in ``[0, resolved_n_threads)``
    regardless of who chose the count."""
    pegs = np.ascontiguousarray(pegs, np.uint32)
    playable = np.ascontiguousarray(playable, np.uint32)
    n = len(pegs)
    lib = _try_load()
    n_threads = resolve_n_threads(n_threads)
    workers = np.zeros(n, np.int32)
    if lib is None:
        from icikit_torch.models.solitaire.game import solve_one_py
        solved = np.zeros(n, bool)
        n_moves = np.zeros(n, np.int32)
        moves = np.full((n, MAX_DEPTH), -1, np.int32)
        steps = np.zeros(n, np.int64)
        for i in range(n):
            ok, ms, st = solve_one_py(int(pegs[i]), int(playable[i]),
                                      max_steps)
            solved[i] = ok
            n_moves[i] = len(ms)
            moves[i, :len(ms)] = ms
            steps[i] = st
        if return_workers:
            return solved, n_moves, moves, steps, workers
        return solved, n_moves, moves, steps
    solved = np.zeros(n, np.uint8)
    n_moves = np.zeros(n, np.int32)
    moves = np.full((n, MAX_DEPTH), -1, np.int32)
    steps = np.zeros(n, np.int64)
    if n:
        lib.ik_solve_batch_w(
            pegs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            playable.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            n, max_steps, n_threads, chunk_size,
            solved.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            n_moves.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            moves.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            steps.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            workers.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if return_workers:
        return solved.astype(bool), n_moves, moves, steps, workers
    return solved.astype(bool), n_moves, moves, steps


def markov_fill(vocab: int, branch: int, table_seed: int, stream_seed: int,
                batch: int, seq: int, n_threads: int = 0):
    """Fill an int32 (batch, seq+1) Markov-corpus array. Native when
    available; the numpy fallback computes the identical splitmix64
    arithmetic, so the corpus is a pure function of the seeds either
    way (the trainer may resume on a host without a toolchain)."""
    out = np.empty((batch, seq + 1), np.int32)
    lib = _try_load()
    if lib is not None:
        rc = lib.ik_markov_fill(
            vocab, branch, table_seed & (2**64 - 1),
            stream_seed & (2**64 - 1), batch, seq, n_threads,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if rc != 0:
            raise ValueError(f"ik_markov_fill failed (code {rc})")
        return out
    return _markov_fill_py(vocab, branch, table_seed, stream_seed,
                           batch, seq, out)


def _mix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15))
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _markov_fill_py(vocab, branch, table_seed, stream_seed, batch, seq,
                    out):
    with np.errstate(over="ignore"):
        ts = np.uint64(table_seed & (2**64 - 1))
        ss = np.uint64(stream_seed & (2**64 - 1))
        rows = np.arange(batch, dtype=np.uint64)
        # hash the (small-integer) stream seed so adjacent seeds do not
        # produce shifted-identical draw streams (base + t collisions)
        base = _mix64(ss) ^ _mix64(rows)              # (batch,)
        out[:, 0] = (_mix64(base ^ np.uint64(0x243F6A8885A308D3))
                     % np.uint64(vocab)).astype(np.int32)
        out[:, 1] = (_mix64(base ^ np.uint64(0x13198A2E03707344))
                     % np.uint64(vocab)).astype(np.int32)
        w = np.arange(branch, 0, -1, dtype=np.float64)
        cum = (w / w.sum()).cumsum()
        t_idx = np.arange(seq + 1, dtype=np.uint64)
        u = ((_mix64(base[:, None] + t_idx[None, :]) >> np.uint64(11))
             * (1.0 / 9007199254740992.0))            # (batch, seq+1)
        picks = np.minimum(np.searchsorted(cum, u, side="right"),
                           branch - 1).astype(np.uint64)
        for t in range(2, seq + 1):
            a = out[:, t - 2].astype(np.uint64)
            b = out[:, t - 1].astype(np.uint64)
            h = _mix64(ts ^ _mix64(a * np.uint64(vocab) + b)
                       ^ picks[:, t] * np.uint64(0xD6E8FEB86659FD93))
            out[:, t] = (h % np.uint64(vocab)).astype(np.int32)
    return out
