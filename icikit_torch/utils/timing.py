"""Timing utilities: the median-of-windows headline protocol.

The reference's protocol (``Parallel-Sorting/src/psort.cc:617-655``) is
barrier, timer, work, timer, per-run mean. On a card the analog needs a
completion fence, because launches return before the device finishes:
here a ``torch.cuda.synchronize()`` plus a data-dependent scalar read
takes the place of JAX's ``block_until_ready``. Each run's input derives
from the previous run's output (``chain``), and constant costs cancel by
two-point measurement: per-run = (t(2n) - t(n)) / n.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import torch


class Stopwatch:
    """Reset-on-read stopwatch (reference ``get_timer``)."""

    def __init__(self):
        self._last = time.perf_counter()

    def __call__(self) -> float:
        now = time.perf_counter()
        elapsed = now - self._last
        self._last = now
        return elapsed


def _leaves(a):
    if isinstance(a, torch.Tensor):
        return [a]
    if isinstance(a, (tuple, list)):
        return [t for x in a for t in _leaves(x)]
    return []


def fence(out):
    """Wait for every launch that ``out`` depends on and return it."""
    leaves = _leaves(out)
    if any(t.is_cuda for t in leaves):
        torch.cuda.synchronize()
    for t in leaves:
        if t.numel():
            t.reshape(-1)[0].item()
    return out


def _make_chain_measure(fn, args, chain):
    """(state, measure): ``measure(n)`` times n chained runs, continuing
    the chain from where the last window left off."""
    state = {"cur": args}

    def measure(n):
        cur = state["cur"]
        watch = Stopwatch()
        for _ in range(n):
            cur = chain(cur, fn(*cur))
        fence(cur)
        t = watch()
        state["cur"] = cur
        return t

    return state, measure


def _resolve_target_window(state) -> float:
    """Window target: small on the CPU, where dispatch noise is
    microseconds; 0.25 s on the card."""
    on_cuda = any(t.is_cuda for t in _leaves(state["cur"]))
    return 0.25 if on_cuda else 0.02


def _two_point_window(measure, runs, target_window_s):
    """One two-point measurement: (per-run seconds, window size, total
    wall seconds, executed run count)."""
    executed = 0
    n, probe = runs, measure(runs)
    executed += runs
    while probe < target_window_s and n < 4096:
        n = n * max(2, int(1.2 * target_window_s / max(probe, 1e-3)))
        probe = measure(n)
        executed += n
    t2 = measure(2 * n)
    executed += 2 * n
    per = (t2 - probe) / n
    window = 2 * n
    if per <= 0:  # cross-measurement noise: retry once, larger window
        probe, t2 = measure(2 * n), measure(4 * n)
        executed += 6 * n
        per = (t2 - probe) / (2 * n)
        window = 4 * n
        if per <= 0:
            per = t2 / (4 * n)
    return per, window, probe + t2, executed


@dataclass
class WindowsResult:
    """Median-of-windows measurement with spread."""
    median_s: float
    min_s: float
    max_s: float
    windows: int           # windows kept
    discarded: int         # implausibly-fast windows dropped
    per_window_s: list
    total_runs: int = 0    # executions actually performed
    # True when EVERY window fell below floor_s: the stats above are
    # then the implausible readings themselves, reported as suspect.
    suspect: bool = False
    # Extra windows were run because the first set spread wider than
    # escalate_ratio; degraded = the set never converged.
    escalated: bool = False
    degraded: bool = False

    @property
    def spread_ratio(self) -> float:
        if self.median_s <= 0:
            return float("inf")
        return (self.max_s - self.min_s) / self.median_s

    def session_quality(self) -> dict:
        """Provenance blob for records: spread, escalation, and the
        session canary (``session_canary``)."""
        q = {
            "spread_ratio": round(self.spread_ratio, 4),
            "escalated": self.escalated,
            "degraded": self.degraded,
        }
        canary = session_canary()
        if canary:
            q.update(canary)
        return q


# The canary: a fixed memory-streaming kernel chain (saxpy on 8 MiB of
# float32 for 16 iterations) timed once per process and stamped into
# every headline record, so two sessions' numbers can be told apart
# from a card that was slower that day.

_CANARY_N = 1 << 21
_CANARY_ITERS = 16
_canary_cache: dict | None = None


def session_canary(refresh: bool = False) -> dict | None:
    """Measured throughput of the canary chain on the card, cached per
    process: ``{"canary_gbs", "canary_ms"}``. None when disabled
    (``ICIKIT_CANARY=0``) or without a card."""
    global _canary_cache
    if os.environ.get("ICIKIT_CANARY", "1").lower() in ("0", "off"):
        return None
    if not torch.cuda.is_available():
        return None
    if _canary_cache is not None and not refresh:
        return _canary_cache
    x = torch.arange(_CANARY_N, dtype=torch.float32, device="cuda") * 1e-6

    def f(v):
        for _ in range(_CANARY_ITERS):
            v = v * 1.0000001 + 0.5
        return v

    state, measure = _make_chain_measure(f, (x,), lambda a, out: (out,))
    measure(2)
    per, _, _, _ = _two_point_window(measure, 2, 0.02)
    nbytes = 2.0 * 4 * _CANARY_N * _CANARY_ITERS
    _canary_cache = {"canary_gbs": round(nbytes / per / 1e9, 1),
                     "canary_ms": round(per * 1e3, 3)}
    return _canary_cache


def _median(xs: list) -> float:
    s = sorted(xs)
    mid = len(s) // 2
    return s[mid] if len(s) % 2 else 0.5 * (s[mid - 1] + s[mid])


def _spread_converged(pers: list, ratio: float,
                      trim: bool = False) -> bool:
    """Has the window set converged to within ``ratio``·median? With
    ``trim`` (only once escalation has begun) and >= 5 windows, the
    single min and max are left out of the judgment."""
    xs = sorted(pers)
    if trim and len(xs) >= 5:
        xs = xs[1:-1]
    return (xs[-1] - xs[0]) <= ratio * _median(xs)


def _collect_windows(window_fn, windows: int, floor_s: float | None,
                     escalate_ratio: float, max_windows: int):
    """Collection and escalation, apart from the device chain so it can
    be tested against a synthetic timer.

    ``window_fn() -> (per_run_s, executed_runs)`` performs one window.
    Collects ``windows`` floor-respecting windows (each discard retried,
    up to 2x attempts per phase); while the kept spread exceeds
    ``escalate_ratio``·median, runs ``windows`` more, up to
    ``max_windows`` kept.
    """
    pers, dropped, total_runs = [], [], 0

    def collect(k):
        nonlocal total_runs
        added = 0
        for _ in range(2 * k):
            if added >= k:
                break
            per, execd = window_fn()
            total_runs += execd
            if floor_s is not None and per < floor_s:
                dropped.append(per)
                continue
            pers.append(per)
            added += 1
        return added

    collect(windows)
    escalated = False
    while (len(pers) >= 2 and len(pers) < max_windows
           and not _spread_converged(pers, escalate_ratio,
                                     trim=escalated)):
        escalated = True
        if collect(min(windows, max_windows - len(pers))) == 0:
            break
    degraded = bool(pers and len(pers) >= 2
                    and not _spread_converged(pers, escalate_ratio,
                                              trim=escalated))
    return pers, dropped, total_runs, escalated, degraded


def timeit_windows(fn, args: tuple, chain, windows: int = 5,
                   runs: int = 4, warmup: int = 1,
                   target_window_s: float | None = None,
                   floor_s: float | None = None,
                   escalate_ratio: float = 0.15,
                   max_windows: int | None = None) -> WindowsResult:
    """``windows`` independent two-point measurements over ONE
    continuing chain, reported as median with [min, max] spread.
    Windows faster than ``floor_s`` (a physical lower bound on one run)
    are discarded and re-measured; a spread wider than
    ``escalate_ratio`` of the median runs more windows, up to
    ``max_windows`` (default 3x ``windows``)."""
    if windows < 1:
        raise ValueError(f"windows must be >= 1, got {windows}")
    if max_windows is None:
        max_windows = 3 * windows
    state, measure = _make_chain_measure(fn, args, chain)
    for _ in range(max(warmup, 1)):
        state["cur"] = chain(state["cur"], fn(*state["cur"]))
    fence(state["cur"])
    if target_window_s is None:
        target_window_s = _resolve_target_window(state)
    run_state = {"runs": runs}

    def window_fn():
        per, win, _, execd = _two_point_window(measure, run_state["runs"],
                                               target_window_s)
        run_state["runs"] = max(run_state["runs"], win // 2)
        return per, execd

    pers, dropped, total_runs, escalated, degraded = _collect_windows(
        window_fn, windows, floor_s, escalate_ratio, max_windows)
    suspect = False
    if not pers:
        pers, dropped, suspect = dropped, [], True
    return WindowsResult(median_s=_median(pers), min_s=min(pers),
                         max_s=max(pers), windows=len(pers),
                         discarded=len(dropped), per_window_s=pers,
                         suspect=suspect, total_runs=total_runs,
                         escalated=escalated, degraded=degraded)


@dataclass
class TimeitResult:
    """Per-run times of :func:`timeit`."""
    mean_s: float          # per-run mean, as the reference reports
    total_s: float
    runs: int
    per_run_s: list        # individual run times

    @property
    def best_s(self) -> float:
        return min(self.per_run_s)


def timeit_chained(fn, args: tuple, chain, runs: int = 10,
                   warmup: int = 2,
                   target_window_s: float | None = None) -> TimeitResult:
    """One two-point measurement over a chain: each run's input derives
    from the previous run's output (``chain(args, out) -> args``), the
    chain is fenced once at the end of a window, and constant costs
    cancel: per-run = (t(2n) - t(n)) / n, n grown until t(n) reaches
    the target window. The cheaper protocol of the sort study's
    ``windows=1``; ``timeit_windows`` repeats it for a spread."""
    state, measure = _make_chain_measure(fn, args, chain)
    for _ in range(max(warmup, 1)):
        state["cur"] = chain(state["cur"], fn(*state["cur"]))
    fence(state["cur"])
    if target_window_s is None:
        target_window_s = _resolve_target_window(state)
    per, window, total, _ = _two_point_window(measure, runs,
                                              target_window_s)
    return TimeitResult(mean_s=per, total_s=total, runs=window,
                        per_run_s=[per] * window)


def _wait(out):
    if any(t.is_cuda for t in _leaves(out)):
        torch.cuda.synchronize()
    return out


def timeit(fn, *args, runs: int = 10, warmup: int = 2) -> TimeitResult:
    """Time ``fn(*args)`` run by run, each run fenced by a device
    synchronise (the host clock then spans the launches and the device
    work): the reference's ``test_runs`` loop
    (``Communication/src/main.cc:427-443``) after ``warmup`` runs."""
    for _ in range(warmup):
        _wait(fn(*args))
    per_run = []
    watch = Stopwatch()
    for _ in range(runs):
        watch()
        _wait(fn(*args))
        per_run.append(max(watch(), 1e-9))
    total = sum(per_run)
    return TimeitResult(mean_s=total / runs, total_s=total, runs=runs,
                        per_run_s=per_run)


def cuda_time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` on the card, by CUDA events around
    ``iters`` back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
