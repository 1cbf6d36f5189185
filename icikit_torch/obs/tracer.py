"""Host-side spans with Chrome-trace/Perfetto export (a copy of
``icikit.obs.tracer``; only the device mirror differs).

``span("solve.chunk", chunk=3)`` opens a named region on the calling
thread's timeline; regions nest (a thread-local stack tracks the
parent), carry attributes, and land in a :class:`TraceBuffer` as
Chrome-trace ``B``/``E`` duration events with monotonic microsecond
timestamps — ``export`` writes a ``trace.json`` that loads directly in
``chrome://tracing`` or https://ui.perfetto.dev.

Fast path: with no tracer armed, :func:`span` returns one shared no-op
context manager — no allocation, no clock read, no formatting (the
``icikit_torch.chaos`` probe discipline). Arm with
:func:`start_tracing`; the ``ICIKIT_OBS`` session and the Chrome export
(``icikit.obs.chrome``) are not ported yet.

``mirror_device=True`` additionally wraps each span in
``torch.profiler.record_function``, so when a ``torch.profiler``
session is active the host spans appear in its trace beside the
device's kernels and the two correlate by name.
"""

from __future__ import annotations

import os
import threading
import time

_TRACE = None               # TraceBuffer | None; lock-free hot-path read
_LOCK = threading.Lock()


def _now_us() -> int:
    # monotonic microseconds — Chrome-trace's native unit; perf_counter
    # is one clock for all threads, so per-thread ordering is free
    return time.perf_counter_ns() // 1000


class TraceBuffer:
    """Accumulates Chrome-trace events; thread-safe, append-only."""

    def __init__(self, mirror_device: bool = False):
        self.events: list = []
        self.pid = os.getpid()
        self.mirror_device = mirror_device
        self._lock = threading.Lock()
        self._next_id = 0
        self._next_tid = 1
        self._tls = threading.local()
        self._annotation_cls = None
        if mirror_device:
            try:  # resolved once; obs stays importable without torch
                from torch.profiler import record_function
                self._annotation_cls = record_function
            except Exception:
                self.mirror_device = False

    def _tid(self) -> int:
        """This thread's timeline id: a synthetic per-buffer counter,
        NOT ``threading.get_ident()`` — the OS reuses idents after a
        thread exits, which would merge a new worker's spans onto a
        dead thread's Perfetto track under the dead thread's name."""
        tid = getattr(self._tls, "tid", None)
        if tid is None:
            with self._lock:
                tid = self._tls.tid = self._next_tid
                self._next_tid += 1
                self.events.append({
                    "ph": "M", "name": "thread_name", "pid": self.pid,
                    "tid": tid,
                    "args": {"name": threading.current_thread().name}})
        return tid

    # -- span bookkeeping (called from _Span only) -------------------

    def _open(self, name: str, attrs: dict) -> tuple:
        tid = self._tid()
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            args = {"trace_id": sid}
            if stack:
                args["parent"] = stack[-1]
            if attrs:
                args.update(attrs)
            self.events.append({
                "ph": "B", "name": name, "pid": self.pid, "tid": tid,
                "ts": _now_us(), "args": args})
        stack.append(sid)
        return sid, tid

    def _close(self, name: str, tid: int) -> None:
        stack = getattr(self._tls, "stack", None)
        if stack:
            stack.pop()
        with self._lock:
            self.events.append({
                "ph": "E", "name": name, "pid": self.pid, "tid": tid,
                "ts": _now_us()})

    def instant(self, name: str, **attrs) -> None:
        """One tick mark on the calling thread's timeline (Chrome ``i``
        event) — for point-in-time facts like ``chaos.fired``."""
        tid = self._tid()
        with self._lock:
            self.events.append({
                "ph": "i", "name": name, "pid": self.pid,
                "tid": tid, "ts": _now_us(),
                "s": "t", "args": dict(attrs)})

    def async_event(self, ph: str, name: str, cat: str, aid: str,
                    attrs: dict | None = None) -> None:
        """One Chrome ASYNC event (``ph`` in ``b``/``e``/``n``): a span
        keyed by ``(cat, id)`` instead of by thread, so it may open on
        one thread (or synthetic engine track) and close on another —
        the request-scoped tracing primitive (JAX's ``icikit.obs.trace_ctx``,
        not ported yet).
        Perfetto groups all events of one ``(cat, id)`` into one track;
        the structural validator pairs ``b``/``e`` per ``(cat, id)``
        LIFO (JAX's ``icikit.obs.chrome``)."""
        tid = self._tid()
        ev = {"ph": ph, "name": name, "cat": cat, "id": aid,
              "pid": self.pid, "tid": tid, "ts": _now_us()}
        if attrs:
            ev["args"] = dict(attrs)
        # lock-free append: list.append is atomic under the GIL and
        # async events carry no cross-event nesting state (pairing is
        # by (cat, id) at validate time) — this is the serving engine's
        # per-step hot path (measured for JAX's copy in
        # tools/trace_overhead_study.py)
        self.events.append(ev)

    def snapshot(self) -> list:
        with self._lock:
            return list(self.events)


class _Span:
    """A live span (context manager). ``trace_id`` is the span's id in
    the trace — stamp it into records (e.g. ``BenchRecord.trace_id``)
    so report rows correlate with trace regions."""

    __slots__ = ("name", "attrs", "trace_id", "_tb", "_tid", "_ann")

    def __init__(self, tb: TraceBuffer, name: str, attrs: dict):
        self._tb = tb
        self.name = name
        self.attrs = attrs
        self.trace_id = None
        self._tid = None
        self._ann = None

    def __enter__(self):
        if self._tb._annotation_cls is not None:
            self._ann = self._tb._annotation_cls(self.name)
            self._ann.__enter__()
        self.trace_id, self._tid = self._tb._open(self.name, self.attrs)
        return self

    def __exit__(self, *exc):
        # _tid is None when __enter__ died partway (e.g. the device
        # annotation raised): closing an unopened span would corrupt
        # the nesting, and an AttributeError here would mask the
        # original failure in a caller's finally
        if self._tid is not None:
            self._tb._close(self.name, self._tid)
        if self._ann is not None:
            self._ann.__exit__(*exc)
        return False


class _NoopSpan:
    """The shared disabled span: entering/exiting does nothing and
    allocates nothing (``span()`` returns this very singleton)."""

    __slots__ = ()
    name = None
    trace_id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP_SPAN = _NoopSpan()


def span(name: str, **attrs):
    """Open a named region on this thread's timeline (use as a context
    manager). Disabled → returns the shared no-op singleton."""
    tb = _TRACE
    if tb is None:
        return NOOP_SPAN
    return _Span(tb, name, attrs)


def traced(name: str | None = None, **attrs):
    """Decorator form: ``@traced("solve.chunk")`` wraps each call of
    the function in a span (function's qualname when ``name`` is
    omitted). The disabled-path cost is one global read per call."""
    def deco(fn):
        label = name or fn.__qualname__

        def wrapper(*a, **kw):
            tb = _TRACE
            if tb is None:
                return fn(*a, **kw)
            with _Span(tb, label, attrs):
                return fn(*a, **kw)
        wrapper.__name__ = fn.__name__
        wrapper.__qualname__ = fn.__qualname__
        wrapper.__doc__ = fn.__doc__
        wrapper.__wrapped__ = fn
        return wrapper
    return deco


def instant(name: str, **attrs) -> None:
    """Record an instant event on the active trace (no-op when
    disabled)."""
    tb = _TRACE
    if tb is None:
        return
    tb.instant(name, **attrs)


def tracing() -> TraceBuffer | None:
    """The armed trace buffer, or None when tracing is disabled."""
    return _TRACE


def start_tracing(mirror_device: bool = False) -> TraceBuffer:
    """Arm a fresh process-wide trace buffer and return it (replaces
    any previous one)."""
    global _TRACE
    with _LOCK:
        _TRACE = TraceBuffer(mirror_device=mirror_device)
        return _TRACE


def stop_tracing() -> TraceBuffer | None:
    """Disarm tracing; returns the buffer that was recording (so the
    caller can export it)."""
    global _TRACE
    with _LOCK:
        tb, _TRACE = _TRACE, None
        return tb


def _swap(tb: TraceBuffer | None) -> TraceBuffer | None:
    """Install ``tb`` (may be None), returning the previous buffer —
    the restore primitive scoped sessions need."""
    global _TRACE
    with _LOCK:
        prev, _TRACE = _TRACE, tb
        return prev
