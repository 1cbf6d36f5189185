"""Process hardening: crash traps + runaway-job watchdog.

The reference wraps every ``main`` in ``chopsigs_()``
(``Dynamic-Load-Balancing/src/utilities.cc:49-58``): trap fatal signals
into a diagnostic line + abort, and arm an alarm so a hung run cannot
wedge the batch queue. Same discipline here, implemented in the port's
native runtime (``icikit_torch/native/src/guard.cc``) with a
Python-signal fallback; CLI entry points call ``chopsigs()`` first, as
every reference ``main`` does (``psort.cc:532``, ``main.cc:196``). The
port's copy of ``icikit.utils.guard``: the same rules and the same
``ICIKIT_WATCHDOG_S`` variable.
"""

from __future__ import annotations

import os

# Reference watchdog budgets: 1200 s (utilities.cc:10), 540 s / 120 s
# debug (psort.cc:17, :539-543).
DEFAULT_TIMEOUT_S = 1200
DEBUG_TIMEOUT_S = 120

# The Python-fallback SIGALRM handler that chopsigs displaced (restored
# by disarm); a sentinel distinguishes "fallback never installed".
_NO_SAVED = object()
_saved_py_alarm = _NO_SAVED

# The timeout most recently armed by chopsigs (telemetry/tests).
_armed_timeout_s: int | None = None


def _env_watchdog_s() -> int | None:
    """``ICIKIT_WATCHDOG_S`` parsed once for every consumer: None when
    unset, empty, or unparsable; otherwise ``max(0, value)`` (0 =
    explicit off)."""
    raw = os.environ.get("ICIKIT_WATCHDOG_S")
    if raw is None or not raw.strip():
        return None
    try:
        return max(0, int(raw))
    except ValueError:
        return None


def default_timeout_s() -> int:
    """The budget an explicit ``chopsigs()`` arms when the caller names
    none: ``ICIKIT_WATCHDOG_S`` when set to a positive integer (batch
    queues tune the runaway budget without touching every entry point),
    else the reference's 1200 s — the caller asked to arm, so an off/
    invalid env value falls back to the default rather than disarming."""
    v = _env_watchdog_s()
    return v if v else DEFAULT_TIMEOUT_S


def resolve_watchdog_s(flag: int | None) -> int:
    """Watchdog budget for a CLI entry point (0 = do not arm): an
    explicit ``--watchdog`` flag always wins — including 0 for off —
    and with no flag a *set* ``ICIKIT_WATCHDOG_S`` arms its value.
    ``ICIKIT_WATCHDOG_S=0`` (or any non-positive/unparsable value)
    means off, mirroring the flag's 0-disables contract."""
    if flag is not None:
        return max(0, flag)
    return _env_watchdog_s() or 0


def chopsigs(timeout_s: int | None = None) -> bool:
    """Install fatal-signal traps and arm the watchdog (default budget:
    :func:`default_timeout_s`, i.e. ``ICIKIT_WATCHDOG_S`` or 1200 s).
    Returns True if the native trap path is active (False means only
    the alarm is armed, via Python's signal module)."""
    global _saved_py_alarm, _armed_timeout_s
    from icikit_torch import native

    if timeout_s is None:
        timeout_s = default_timeout_s()
    ok = native.install_traps()
    if not ok:
        # Fallback: at least make the watchdog fire as a Python exception.
        import signal

        def _alarm(signum, frame):
            raise TimeoutError(
                f"icikit watchdog: run exceeded {timeout_s} s")

        prev = signal.signal(signal.SIGALRM, _alarm)
        if _saved_py_alarm is _NO_SAVED:  # keep the pre-first snapshot
            _saved_py_alarm = prev
    native.watchdog(timeout_s)
    _armed_timeout_s = timeout_s
    return ok


def armed_timeout_s() -> int | None:
    """The budget the last ``chopsigs`` armed, or None after
    ``disarm``/before any arm (telemetry/tests)."""
    return _armed_timeout_s


def disarm() -> None:
    """Cancel the watchdog and restore the signal dispositions that were
    active before ``chopsigs``.

    Restoring matters as much as cancelling: the trap handler
    hard-exits (the reference's MPI_Abort discipline), and a process
    that finished its guarded run must stop treating teardown-time
    signals — which a default process never notices — as fatal.
    """
    global _saved_py_alarm, _armed_timeout_s
    from icikit_torch import native

    native.watchdog(0)
    _armed_timeout_s = None
    native.restore_traps()
    if _saved_py_alarm is not _NO_SAVED:
        import signal

        signal.signal(signal.SIGALRM, _saved_py_alarm)
        _saved_py_alarm = _NO_SAVED
