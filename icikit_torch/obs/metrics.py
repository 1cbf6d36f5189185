"""Metrics registry: counters, gauges, histograms (a copy of
``icikit.obs.metrics``, host-only Python).

Where spans answer "where did the time go *this run*", metrics answer
"how much, in total": bytes moved per collective, chunks reissued by
the scheduler, per-step latency percentiles. The registry is
dependency-free and snapshot-oriented — :func:`snapshot` returns one
JSON-safe dict that bench reports stamp into their record files.

Fast path (the chaos/bus discipline): module-level helpers
(:func:`count`, :func:`gauge`, :func:`observe`) are one global read +
``None`` check when no registry is enabled — hot loops instrument
unconditionally and pay nothing in production.
"""

from __future__ import annotations

import threading

_METRICS = None             # Registry | None; lock-free hot-path read
_LOCK = threading.Lock()


class Counter:
    """Monotonic accumulator (``scheduler.reissues``,
    ``collective.bytes``)."""

    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0
        self._lock = threading.Lock()

    def add(self, n=1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-written value (``scheduler.workers_alive``)."""

    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)


class Histogram:
    """Streaming distribution with exact count/sum/min/max and
    percentile estimates from a bounded, deterministically-decimated
    sample.

    When the sample buffer fills, every other retained sample is
    dropped and the keep-stride doubles — no RNG (reservoir sampling
    would make snapshots run-order dependent), bounded memory, and for
    the benchmark-scale streams this serves (10^2..10^5 observations)
    the stride-decimated sample still covers the whole stream evenly.
    """

    __slots__ = ("count", "total", "min", "max", "_sample", "_stride",
                 "_seen", "_lock", "_cap", "_over")

    def __init__(self, cap: int = 4096):
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self._sample: list = []
        self._stride = 1
        self._seen = 0
        self._cap = cap
        self._over: dict = {}   # threshold -> observations above it
        self._lock = threading.Lock()

    def observe(self, v) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v
            for t in self._over:
                if v > t:
                    self._over[t] += 1
            self._seen += 1
            if self._seen >= self._stride:
                self._seen = 0
                self._sample.append(v)
                if len(self._sample) >= self._cap:
                    self._sample = self._sample[::2]
                    self._stride *= 2

    def track_over(self, threshold: float) -> None:
        """Arm an exact above-``threshold`` observation count (the SLO
        burn-rate numerator — a windowed violation *fraction* cannot be
        recovered from decimated percentiles, so the watch layer
        registers its thresholds up front and the histogram counts
        crossings at observe time: one compare per armed threshold).
        Idempotent; counts observations from arming onward."""
        with self._lock:
            self._over.setdefault(float(threshold), 0)

    def percentile(self, q: float) -> float | None:
        """Nearest-rank percentile over the retained sample (q in
        [0, 100])."""
        with self._lock:
            s = sorted(self._sample)
        return self._pct(s, q)

    @staticmethod
    def _pct(s: list, q: float):
        if not s:
            return None
        idx = min(len(s) - 1, max(0, round(q / 100.0 * (len(s) - 1))))
        return s[idx]

    def summary(self) -> dict:
        # one lock-scoped copy of EVERY field: the watch layer
        # snapshots mid-run against concurrent engine-thread observes,
        # and a count read in one instant with a sum read in the next
        # is a torn record (mean drifts, burn rates go negative)
        with self._lock:
            count, total = self.count, self.total
            mn, mx = self.min, self.max
            sample = sorted(self._sample)
            over = dict(self._over)
        out = {
            "count": count, "sum": total,
            "min": mn, "max": mx,
            "mean": (total / count) if count else None,
            "p50": self._pct(sample, 50), "p99": self._pct(sample, 99),
        }
        if over:
            out["over"] = {str(t): n for t, n in sorted(over.items())}
        return out


class Registry:
    """Named metric store; names are dotted strings
    (``train.step_ms``). First access creates the metric, so a clean
    run still snapshots its zero counters — "0 reissues" is a
    statement, "no such key" is a blind spot."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def _get(self, table: dict, name: str, cls):
        with self._lock:
            m = table.get(name)
            if m is None:
                m = table[name] = cls()
            return m

    def counter(self, name: str) -> Counter:
        return self._get(self._counters, name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(self._gauges, name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(self._histograms, name, Histogram)

    def snapshot(self) -> dict:
        """JSON-safe view of every metric, for record files. Safe
        against concurrent emits: the table copy is lock-scoped here
        and every histogram summary is lock-scoped in
        :meth:`Histogram.summary` (counter/gauge values are single
        atomic reads)."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        return {
            "counters": {k: c.value for k, c in sorted(counters.items())},
            "gauges": {k: g.value for k, g in sorted(gauges.items())},
            "histograms": {k: h.summary()
                           for k, h in sorted(histograms.items())},
        }

    def clear_gauges(self, prefix: str = "") -> None:
        """Drop every gauge whose name starts with ``prefix``. Gauges
        are last-written values: a bench arm that never writes (say)
        ``serve.occupancy_rows`` would otherwise snapshot the PREVIOUS
        arm's parting value into its own record — arms call this at
        their timed-window start so a stale gauge reads as absent, not
        as a plausible number."""
        with self._lock:
            for k in [k for k in self._gauges if k.startswith(prefix)]:
                del self._gauges[k]


# -- module-level fast-path helpers ---------------------------------

def metrics() -> Registry | None:
    """The enabled registry, or None when metrics are disabled."""
    return _METRICS


def enable_metrics() -> Registry:
    """Arm a fresh process-wide registry and return it."""
    global _METRICS
    with _LOCK:
        _METRICS = Registry()
        return _METRICS


def disable_metrics() -> Registry | None:
    """Disarm; returns the registry that was live (for a final
    snapshot)."""
    global _METRICS
    with _LOCK:
        reg, _METRICS = _METRICS, None
        return reg


def _swap(reg: Registry | None) -> Registry | None:
    """Install ``reg`` (may be None), returning the previous registry —
    the restore primitive scoped sessions need."""
    global _METRICS
    with _LOCK:
        prev, _METRICS = _METRICS, reg
        return prev


def count(name: str, n=1) -> None:
    """Bump a counter (creates it at 0 first — so passing ``n=0``
    *registers* the metric without moving it)."""
    reg = _METRICS
    if reg is None:
        return
    c = reg.counter(name)
    if n:
        c.add(n)


def gauge(name: str, v: float) -> None:
    reg = _METRICS
    if reg is None:
        return
    reg.gauge(name).set(v)


def observe(name: str, v: float) -> None:
    reg = _METRICS
    if reg is None:
        return
    reg.histogram(name).observe(v)


def snapshot() -> dict | None:
    """Snapshot of the enabled registry, or None when disabled."""
    reg = _METRICS
    return None if reg is None else reg.snapshot()
