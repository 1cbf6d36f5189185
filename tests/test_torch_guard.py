"""The port's watchdog/trap lifecycle (``icikit_torch.utils.guard``),
the cases of ``tests/test_guard.py``: disarm must undo everything
chopsigs installed, and the 1200 s reference budget must be overridable
per-queue via ICIKIT_WATCHDOG_S, as in JAX's guard; and the port's
guard installs its traps through the port's own native runtime."""

import signal

import pytest

from icikit.utils import guard as jax_guard
from icikit_torch import native
from icikit_torch.utils import guard


@pytest.fixture
def fake_native(monkeypatch):
    """Route guard through a recording fake of the native layer and
    force the Python-fallback trap path, so the test observes arming/
    disarming without installing real C signal handlers."""
    calls = []
    monkeypatch.setattr(native, "install_traps", lambda: False)
    monkeypatch.setattr(native, "restore_traps", lambda: True)
    monkeypatch.setattr(native, "watchdog", calls.append)
    # isolate from any previously saved fallback handler
    monkeypatch.setattr(guard, "_saved_py_alarm", guard._NO_SAVED)
    monkeypatch.setattr(guard, "_armed_timeout_s", None)
    return calls


def test_default_timeout_is_reference_budget(monkeypatch):
    monkeypatch.delenv("ICIKIT_WATCHDOG_S", raising=False)
    assert guard.default_timeout_s() == guard.DEFAULT_TIMEOUT_S == 1200


@pytest.mark.parametrize("raw,expect", [
    ("77", 77),
    ("0", guard.DEFAULT_TIMEOUT_S),      # non-positive: keep default
    ("-5", guard.DEFAULT_TIMEOUT_S),
    ("soon", guard.DEFAULT_TIMEOUT_S),   # garbage: keep default
    ("", guard.DEFAULT_TIMEOUT_S),
])
def test_watchdog_env_override(monkeypatch, raw, expect):
    monkeypatch.setenv("ICIKIT_WATCHDOG_S", raw)
    assert guard.default_timeout_s() == expect


@pytest.mark.parametrize("flag,raw,expect", [
    (30, "77", 30),     # explicit flag always wins
    (0, "77", 0),       # including 0 = off
    (None, "77", 77),   # no flag: a set env arms its value
    (None, None, 0),    # neither: off (CLIs opt in)
    (None, "0", 0),     # set-but-zero = off
    (None, "-5", 0),    # non-positive = off
    (None, "soon", 0),  # unparsable = off
])
def test_resolve_watchdog_s(monkeypatch, flag, raw, expect):
    if raw is None:
        monkeypatch.delenv("ICIKIT_WATCHDOG_S", raising=False)
    else:
        monkeypatch.setenv("ICIKIT_WATCHDOG_S", raw)
    assert guard.resolve_watchdog_s(flag) == expect


def test_chopsigs_arms_env_budget(fake_native, monkeypatch):
    monkeypatch.setenv("ICIKIT_WATCHDOG_S", "345")
    try:
        assert guard.chopsigs() is False  # fallback path forced
        assert fake_native == [345]
        assert guard.armed_timeout_s() == 345
    finally:
        guard.disarm()
    assert fake_native == [345, 0]       # disarm cancelled the alarm
    assert guard.armed_timeout_s() is None


def test_explicit_timeout_beats_env(fake_native, monkeypatch):
    monkeypatch.setenv("ICIKIT_WATCHDOG_S", "345")
    try:
        guard.chopsigs(timeout_s=9)
        assert fake_native == [9]
    finally:
        guard.disarm()


def test_disarm_restores_python_alarm_disposition(fake_native):
    """The fallback SIGALRM handler chopsigs installs must be exactly
    undone by disarm — a guarded run that finished must leave the
    process's signal table as it found it."""
    before = signal.getsignal(signal.SIGALRM)
    guard.chopsigs(timeout_s=30)
    installed = signal.getsignal(signal.SIGALRM)
    assert installed is not before and callable(installed)
    with pytest.raises(TimeoutError):
        installed(signal.SIGALRM, None)  # the watchdog's exception
    guard.disarm()
    assert signal.getsignal(signal.SIGALRM) is before
    # idempotent: a second disarm must not clobber anything
    guard.disarm()
    assert signal.getsignal(signal.SIGALRM) is before


def test_nested_chopsigs_restores_pre_first_snapshot(fake_native):
    """Re-arming without disarming (CLI calls chopsigs, then a library
    call does too) must still restore the ORIGINAL disposition."""
    before = signal.getsignal(signal.SIGALRM)
    guard.chopsigs(timeout_s=30)
    guard.chopsigs(timeout_s=60)  # saved snapshot must not be clobbered
    guard.disarm()
    assert signal.getsignal(signal.SIGALRM) is before


@pytest.mark.parametrize("flag,raw", [(30, "77"), (None, "77"), (None, None),
                                      (None, "soon"), (0, None)])
def test_resolve_watchdog_s_agrees_with_jax(monkeypatch, flag, raw):
    if raw is None:
        monkeypatch.delenv("ICIKIT_WATCHDOG_S", raising=False)
    else:
        monkeypatch.setenv("ICIKIT_WATCHDOG_S", raw)
    assert guard.resolve_watchdog_s(flag) == jax_guard.resolve_watchdog_s(flag)
    assert guard.default_timeout_s() == jax_guard.default_timeout_s()


def test_chopsigs_takes_the_ports_native_traps():
    """On this image the port's library is built, so chopsigs installs
    the native traps (True), and disarm restores the dispositions."""
    assert native.available(), native.build_error()
    before = signal.getsignal(signal.SIGALRM)
    try:
        assert guard.chopsigs(timeout_s=600) is True
        assert guard.armed_timeout_s() == 600
    finally:
        guard.disarm()
    assert guard.armed_timeout_s() is None
    assert signal.getsignal(signal.SIGALRM) == before
