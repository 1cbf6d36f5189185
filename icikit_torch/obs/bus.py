"""Process-wide event bus with pluggable sinks (a copy of
``icikit.obs.bus``, which is host-only Python: the port keeps its own so
that it imports nothing of the JAX package).

The reference's telemetry was rank-0 ``printf`` (SURVEY.md §5.1); the
seed faithfully reproduced it as bare ``print(json.dumps(...))`` lines
scattered through the long-running paths. This bus gives those events
one spine: producers call :func:`emit`, consumers install a
:class:`Sink`, and the two never know about each other.

Contract (shared with ``icikit_torch.chaos``'s probe discipline):

- **zero overhead when disabled** — :func:`emit` with no sink installed
  is one module-global read and a truthiness check; no formatting, no
  locking, no I/O. Call sites that must build expensive payloads guard
  with :func:`enabled` first.
- **strict JSON on the wire** — :class:`JsonlSink` emits one JSON
  object per line and never bare ``NaN``/``Infinity`` (non-finite
  floats become their ``repr`` string, the trainer's established
  NaN-as-string rule), so downstream consumers may use strict parsers.
- events are plain dicts; ``emit("anomaly", step=3)`` produces
  ``{"event": "anomaly", "step": 3}``, and ``emit(None, step=3)``
  produces ``{"step": 3}`` (the trainer's historical bare step record).

Sinks are installed process-wide (``add_sink``/``remove_sink``) or
scoped (``with installed(sink): ...``); the installed set is an
immutable tuple so the hot path reads it without a lock.
"""

from __future__ import annotations

import collections
import json
import math
import sys
import threading

_SINKS: tuple = ()          # lock-free hot-path read
_LOCK = threading.Lock()    # guards mutations of _SINKS only


def enabled() -> bool:
    """True when at least one sink is installed (i.e. building an event
    payload will not be wasted work)."""
    return bool(_SINKS)


def emit(event: str | None, **fields) -> None:
    """Publish one event to every installed sink.

    ``event`` becomes the dict's ``"event"`` key (omitted when None —
    the trainer's bare per-step record predates the schema and keeps
    its historical shape). A sink that raises does not stop delivery
    to the remaining sinks.
    """
    sinks = _SINKS
    if not sinks:
        return
    ev = fields if event is None else {"event": event, **fields}
    for s in sinks:
        try:
            s.write(ev)
        except Exception:  # one broken sink must not kill the producer
            pass


def add_sink(sink) -> None:
    global _SINKS
    with _LOCK:
        _SINKS = _SINKS + (sink,)


def remove_sink(sink) -> None:
    global _SINKS
    with _LOCK:
        _SINKS = tuple(s for s in _SINKS if s is not sink)


class installed:
    """Scope a sink to a ``with`` block (install on enter, remove on
    exit — the pattern every CLI entry point uses so a crashed run
    cannot leak its sink into the caller's process)."""

    def __init__(self, sink):
        self.sink = sink

    def __enter__(self):
        add_sink(self.sink)
        return self.sink

    def __exit__(self, *exc):
        remove_sink(self.sink)
        return False


# -- JSON safety ----------------------------------------------------

def json_safe(obj):
    """Recursively replace non-finite floats with their ``repr`` string
    (the NaN-as-string rule: ``json.dumps`` would happily emit bare
    ``NaN``, which is not JSON and breaks strict consumers)."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else repr(obj)
    if isinstance(obj, dict):
        return {k: json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_safe(v) for v in obj]
    return obj


def dumps_strict(ev: dict) -> str:
    """One event as strict JSON (never bare NaN/Infinity)."""
    try:
        return json.dumps(ev, allow_nan=False)
    except (ValueError, TypeError):
        # the slow path: sanitize non-finite floats / stringify the rest
        return json.dumps(json_safe(ev), default=repr)


# -- sinks ----------------------------------------------------------

class Sink:
    """Sink interface: ``write(ev: dict)``; ``close()`` optional."""

    def write(self, ev: dict) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def close(self) -> None:
        pass


class JsonlSink(Sink):
    """Strict-JSON lines to a stream.

    ``stream`` is a file-like object, or the string ``"stdout"`` /
    ``"stderr"`` — the string form resolves at *write* time, so the
    sink follows redirections like pytest's ``capsys`` swapping
    ``sys.stdout`` between tests.

    ``filter``, when given, is a predicate over the event dict; events
    it rejects are dropped by this sink only. The trainer's stdout
    record sink uses it to keep diagnostic streams (``chaos.*`` probe
    decisions) off the CLI's record contract.
    """

    def __init__(self, stream="stderr", filter=None):
        self._stream = stream
        self._filter = filter

    def _resolve(self):
        if self._stream == "stdout":
            return sys.stdout
        if self._stream == "stderr":
            return sys.stderr
        return self._stream

    def write(self, ev: dict) -> None:
        if self._filter is not None and not self._filter(ev):
            return
        self._resolve().write(dumps_strict(ev) + "\n")


class RingSink(Sink):
    """Bounded in-memory ring — the test-assertion sink ("which events
    fired, in what order?") and the flight recorder for postmortems."""

    def __init__(self, capacity: int = 4096):
        self._ring = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()

    def write(self, ev: dict) -> None:
        with self._lock:
            self._ring.append(ev)

    @property
    def events(self) -> list:
        with self._lock:
            return list(self._ring)

    def of_type(self, event: str) -> list:
        return [e for e in self.events if e.get("event") == event]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


class FileSink(Sink):
    """Strict-JSON lines appended to a file, flushed per event (the
    ChunkCheckpoint durability discipline: a crash loses at most the
    event in flight)."""

    def __init__(self, path):
        self.path = path
        self._lock = threading.Lock()
        self._f = open(path, "a")

    def write(self, ev: dict) -> None:
        with self._lock:
            if self._f.closed:
                return  # late event after close: drop, never crash
            self._f.write(dumps_strict(ev) + "\n")
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()
