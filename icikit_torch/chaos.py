"""Deterministic fault injection: a copy of ``icikit.chaos`` for the port.

The module is host-only Python; the port keeps its own copy, over its own
``icikit_torch.obs``, so that it imports nothing of the JAX package. It
reads the same ``ICIKIT_CHAOS`` variable and keeps the same blake2b
decision stream (:func:`_u64`), so one plan fires at the same call
indices in both packages, and :func:`traced_corrupt_spec` gives the same
taint vectors. The plan and the probes are the process's own: a plan
armed in ``icikit.chaos`` does not arm this one.

JAX's module docstring follows.

The reference's only failure story is fail-fast: trap the signal, print
a diagnostic, ``MPI_Abort`` the farm (``utilities.cc:49-58``;
SURVEY.md §5.3). A production TPU stack instead *survives* stragglers,
worker death, silent data corruption, and flaky checkpoint I/O — and
recovery code that is never exercised is recovery code that does not
work. This module makes failures a first-class, reproducible input:

- every injection point in the framework is a named **site**
  (``"solitaire.worker.3"``, ``"train.loss"``, ``"ckpt.save"``) calling
  one of four probes: :func:`maybe_delay` (straggler / hang),
  :func:`maybe_die` (crash), :func:`maybe_corrupt` (bit-flip, the SDC
  drill), :func:`maybe_io_fail` (flaky storage);
- a :class:`FaultPlan` decides, **deterministically**, which call fires:
  the decision for the *n*-th probe of a given ``(kind, site)`` is a
  pure hash of ``(seed, kind, site, n)`` — independent of thread
  interleaving, wall clock, or global RNG state — so a drill replays
  bit-identically under the same plan;
- plans are armed with the :func:`inject` context manager or the
  ``ICIKIT_CHAOS`` environment variable, and injection is **strictly
  zero-overhead when disabled**: every probe is one module-global read
  and a ``None`` check, no allocation, no lock.

Plan vocabulary (both the dict API and the env-var spec):

- rate entry      ``"die:solitaire.worker.*" -> 0.25``
  (kind ``:`` site-glob -> probability per probe call)
- schedule entry  ``"die:solitaire.worker.1" -> (0,)``
  (these exact call indices fire, regardless of rates)
- env spec        ``ICIKIT_CHAOS="seed=7;die:solitaire.worker.*=0.25;io:ckpt.*=@1+3"``
  (``;``-separated; ``@i+j+k`` is the schedule form)
"""

from __future__ import annotations

import fnmatch
import hashlib
import os
import threading
import time
import warnings
from dataclasses import dataclass, field

import numpy as np

from icikit_torch.obs import bus as _bus
from icikit_torch.obs import tracer as _tracer

KINDS = ("delay", "die", "corrupt", "io")


# -- site registry ---------------------------------------------------
#
# Probe sites used to be bare strings, so a typo in an ICIKIT_CHAOS
# spec or a drill's FaultPlan silently never fired. Every module now
# registers its sites at definition (concrete names, or a glob pattern
# for per-instance families like "solitaire.worker.*"); inject() warns
# when a plan references nothing registered, and tools/chaos_site_lint
# holds tests/tools to the same registry in `make check`.

_SITES: set = set()
_sites_lock = threading.Lock()


def register_site(*names: str) -> None:
    """Declare chaos probe sites (or ``fnmatch`` patterns covering a
    dynamic family). Idempotent; called at module import next to the
    code that owns the probes."""
    with _sites_lock:
        _SITES.update(names)


def registered_sites() -> frozenset:
    return frozenset(_SITES)


def site_known(glob: str) -> bool:
    """Does a plan entry's site glob plausibly reach any registered
    site? True when it matches a registered concrete name, or when it
    overlaps a registered pattern (either direction, plus a
    pattern-instantiation witness — globs on both sides make exact
    intersection undecidable-cheaply; these three cover the shapes the
    repo actually uses)."""
    with _sites_lock:
        sites = tuple(_SITES)
    for s in sites:
        if fnmatch.fnmatchcase(s, glob):
            return True
        if "*" in s and (fnmatch.fnmatchcase(glob, s)
                         or fnmatch.fnmatchcase(s.replace("*", "0"),
                                                glob)):
            return True
    return False


def _site_prefix_known(glob: str) -> bool:
    """Is the glob's parent namespace (everything up to the last dot)
    one a registered site already lives in? The runtime warning in
    :class:`inject` only fires for globs whose parent is populated but
    whose leaf is not ("collective.allgatherr" beside the registered
    "collective.allgather" — almost certainly a typo); an unpopulated
    parent more likely means the owning module simply has not been
    imported yet (lazily-imported modules register sites under shared
    family heads — "collective.train.grad_sync" lives in model.py while
    integrity.py registers "collective.<family>" at package import, so
    a first-component check would cry typo on a perfectly good drill),
    and the drill will fire normally once it is. The static lint
    (tools/chaos_site_lint.py) imports every instrumented module and
    judges full names, so typos in committed drills still fail CI."""
    parent = glob.rpartition(".")[0]
    if not parent:
        # dotless = the root namespace, where bare-chaos unit tests
        # mint synthetic names — never a typo signal worth warning on
        return False
    with _sites_lock:
        parents = {s.rpartition(".")[0] for s in _SITES}
    if any(ch in parent for ch in "*?["):
        return any(fnmatch.fnmatchcase(p, parent) for p in parents)
    return parent in parents


class ChaosError(Exception):
    """Base class for injected faults (lets drills distinguish injected
    failures from organic ones in assertions)."""


class InjectedDeath(ChaosError):
    """An injected worker crash (``maybe_die`` fired)."""


class InjectedIOError(ChaosError, OSError):
    """An injected I/O failure; also an ``OSError`` so production retry
    paths treat it exactly like the real thing."""


def _u64(*parts) -> int:
    """Stable 64-bit hash of the stringified parts — the decision
    stream. blake2b, not ``hash()``: PYTHONHASHSEED must not matter."""
    raw = "|".join(str(p) for p in parts).encode()
    return int.from_bytes(hashlib.blake2b(raw, digest_size=8).digest(),
                          "little")


@dataclass
class FaultPlan:
    """A reproducible fault schedule.

    ``rates`` maps ``"kind:site-glob"`` to a per-call firing
    probability; ``schedule`` maps ``"kind:site-glob"`` to explicit
    call indices that always fire. Globs are ``fnmatch`` patterns over
    site names. The highest matching rate wins; schedule matches fire
    unconditionally. ``log`` records every fired fault as
    ``(kind, site, call_index)`` for drill assertions.
    """

    seed: int = 0
    rates: dict = field(default_factory=dict)
    schedule: dict = field(default_factory=dict)
    delay_s: float = 0.02
    corrupt_mode: str = "bitflip"  # or "nan": poison instead of flip

    def __post_init__(self):
        for key in list(self.rates) + list(self.schedule):
            kind = key.partition(":")[0]
            if kind not in KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r} in {key!r} "
                    f"(known: {', '.join(KINDS)})")
        if self.corrupt_mode not in ("bitflip", "nan"):
            raise ValueError(
                f"unknown corrupt_mode {self.corrupt_mode!r}")
        self._lock = threading.Lock()
        self._counts: dict = {}
        self._sched = {k: frozenset(v if not isinstance(v, int) else (v,))
                       for k, v in self.schedule.items()}
        self.log: list = []

    # -- decision core ----------------------------------------------

    def fires(self, kind: str, site: str) -> bool:
        """Consume one probe call at ``(kind, site)`` and decide it."""
        return self._decide(kind, site)[0]

    def _decide(self, kind: str, site: str) -> tuple:
        # armed-path-only registration: the disabled probes stay one
        # global read + None check; once a plan is consulted the site
        # provably exists, so the registry reflects reality even for
        # sites built from runtime ids
        with _sites_lock:
            _SITES.add(site)
        with self._lock:
            n = self._counts.get((kind, site), 0)
            self._counts[(kind, site)] = n + 1
        fired = False
        for key, idxs in self._sched.items():
            k, _, glob = key.partition(":")
            if k == kind and fnmatch.fnmatchcase(site, glob) and n in idxs:
                fired = True
                break
        if not fired:
            rate = 0.0
            for key, r in self.rates.items():
                k, _, glob = key.partition(":")
                if k == kind and fnmatch.fnmatchcase(site, glob):
                    rate = max(rate, float(r))
            if rate > 0.0:
                fired = _u64(self.seed, kind, site, n) / 2.0**64 < rate
        if fired:
            with self._lock:
                self.log.append((kind, site, n))
        # auditable drills: every probe decision is an event, so soak
        # tests assert exactly which sites fired instead of counting
        # side effects (no sink installed -> emit returns immediately)
        if _bus.enabled():
            _bus.emit("chaos.fired" if fired else "chaos.skipped",
                      kind=kind, site=site, call=n, seed=self.seed)
        if fired:
            # tick mark on the span timeline: a trace shows *where* in
            # a pull/step the fault landed
            _tracer.instant("chaos.fired", kind=kind, site=site, call=n)
        return fired, n

    def fired(self, kind: str, site_glob: str = "*") -> int:
        """How many faults of ``kind`` fired at sites matching the glob
        so far (drill-assertion helper)."""
        with self._lock:
            return sum(1 for k, s, _ in self.log
                       if k == kind and fnmatch.fnmatchcase(s, site_glob))

    # -- fault bodies (called via the module-level probes) ----------

    def _corrupt(self, site: str, n: int, array):
        a = np.array(array, copy=True)
        if a.size == 0:
            return a
        h = _u64(self.seed, "corrupt-loc", site, n)
        if self.corrupt_mode == "nan" and np.issubdtype(a.dtype,
                                                        np.floating):
            a.reshape(-1)[h % a.size] = np.nan
            return a
        buf = bytearray(a.tobytes())
        buf[h % len(buf)] ^= 1 << ((h >> 32) % 8)
        return np.frombuffer(bytes(buf), dtype=a.dtype).reshape(a.shape)


# -- global plan + probes -------------------------------------------
#
# The probes below are THE hot path: when no plan is armed each one is
# a single global load plus an identity check — no allocation, no
# locking, no string formatting (callers pass prebuilt site names).

_ACTIVE: FaultPlan | None = None
_install_lock = threading.Lock()


def active() -> FaultPlan | None:
    """The armed plan, or None when injection is disabled."""
    return _ACTIVE


class inject:
    """Arm ``plan`` for the duration of a ``with`` block (re-entrant:
    the previous plan, if any, is restored on exit)."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan

    def __enter__(self) -> FaultPlan:
        global _ACTIVE
        # a drill whose site glob reaches no registered site is a drill
        # that silently never fires — say so, but only for globs whose
        # site FAMILY is registered (a wholly-unknown prefix usually
        # means the owning module just isn't imported yet — its sites
        # register at import, and warning there would teach users to
        # ignore the real typo signal; synthetic names in bare-chaos
        # unit tests stay quiet the same way)
        if _SITES:
            for key in list(self.plan.rates) + list(self.plan.schedule):
                glob = key.partition(":")[2]
                if not site_known(glob) and _site_prefix_known(glob):
                    warnings.warn(
                        f"chaos plan entry {key!r} matches no "
                        "registered probe site — likely a typo, the "
                        "drill will never fire (known sites: "
                        "icikit_torch.chaos.registered_sites())",
                        RuntimeWarning, stacklevel=2)
                    if _bus.enabled():
                        _bus.emit("chaos.unknown_site", entry=key)
        with _install_lock:
            self._prev = _ACTIVE
            _ACTIVE = self.plan
        return self.plan

    def __exit__(self, *exc):
        global _ACTIVE
        with _install_lock:
            _ACTIVE = self._prev
        return False


def maybe_delay(site: str) -> None:
    """Straggler drill: sleep ``plan.delay_s`` when the plan fires."""
    plan = _ACTIVE
    if plan is None:
        return
    if plan.fires("delay", site):
        time.sleep(plan.delay_s)


def maybe_die(site: str) -> None:
    """Crash drill: raise :class:`InjectedDeath` when the plan fires."""
    plan = _ACTIVE
    if plan is None:
        return
    if plan.fires("die", site):
        raise InjectedDeath(site)


def maybe_corrupt(site: str, array):
    """SDC drill: return ``array`` with one deterministic bit flipped
    (or one element poisoned to NaN in ``corrupt_mode="nan"``) when the
    plan fires; the input object untouched otherwise."""
    plan = _ACTIVE
    if plan is None:
        return array
    fired, n = plan._decide("corrupt", site)
    if fired:
        return plan._corrupt(site, n, array)
    return array


# Traced in-schedule corruption (the device-side SDC drill). The host
# probes above can only corrupt at dispatch boundaries — an array the
# host already holds. Checked collectives instead bake a corruption
# site INTO the jitted schedule (transport.traced_flip) and arm it per
# execution through this taint vector, so a drill flips a bit mid-
# schedule, between two ppermute rounds, where only the in-schedule
# checksum verify can see it. (In the port the vector stays on the host:
# icikit_torch.parallel.transport.traced_flip reads it at each exchange
# and touches the received block only at the armed one.)

TAINT_OFF = np.array([-1, -1, 0, 0], dtype=np.int32)


def traced_corrupt_spec(site: str, n_steps: int, p: int) -> np.ndarray:
    """Consult the armed plan for a traced corruption at ``site``.

    Returns the int32 taint vector ``[step, device, elem_seed, bit]``
    feeding ``transport.traced_flip``: a fired decision picks — as a
    pure hash of ``(seed, site, call_index)``, same determinism as
    every other probe — which of the schedule's ``n_steps`` exchange
    steps flips, on which of ``p`` devices, at which element/bit.
    ``TAINT_OFF`` (never fires, bit-identical execution) when no plan
    is armed, the decision declines, or the schedule has no exchanges.
    """
    plan = _ACTIVE
    if plan is None:
        return TAINT_OFF
    # consult the plan even when the schedule has no exchanges, so a
    # drill's decision indices stay aligned across p (replay-log
    # parity) and plan.fired() reflects the arming — then say loudly
    # that the fired flip had nowhere to land (p=1 grad_check, a
    # 1-wide axis: the drill would otherwise "pass" testing nothing)
    fired, n = plan._decide("corrupt", site)
    if not fired:
        return TAINT_OFF
    if n_steps <= 0:
        warnings.warn(
            f"chaos corrupt:{site} fired but the schedule has no "
            "exchange steps (1-wide axis?) — nothing to corrupt, the "
            "drill exercises no verification",
            RuntimeWarning, stacklevel=2)
        if _bus.enabled():
            _bus.emit("chaos.no_exchange_steps", site=site)
        return TAINT_OFF
    h = _u64(plan.seed, "corrupt-loc", site, n)
    return np.array([h % n_steps, (h >> 20) % max(1, p),
                     (h >> 32) % (1 << 30), (h >> 56) % 32],
                    dtype=np.int32)


def maybe_io_fail(site: str) -> None:
    """Flaky-storage drill: raise :class:`InjectedIOError` when the
    plan fires."""
    plan = _ACTIVE
    if plan is None:
        return
    if plan.fires("io", site):
        raise InjectedIOError(f"injected I/O failure at {site}")


def io_retry(site: str, fn, *, retries: int = 3,
             first_backoff: float = 0.05):
    """Run ``fn()`` behind the ``maybe_io_fail`` probe at ``site``,
    retrying ``OSError`` with bounded exponential backoff — the one
    retry policy shared by every checkpoint writer (a stack that dies
    on one flaky write loses the run it existed to protect). The probe
    sits inside the loop, so a drill exercises the retry path itself:
    each attempt is one probe call."""
    backoff = first_backoff
    for attempt in range(retries + 1):
        try:
            maybe_io_fail(site)
            return fn()
        except OSError:
            if attempt == retries:
                raise
            time.sleep(backoff)
            backoff *= 2


# -- env-var arming -------------------------------------------------

def plan_from_spec(spec: str) -> FaultPlan:
    """Parse an ``ICIKIT_CHAOS`` spec string into a plan. Entries are
    ``;``-separated ``key=value`` pairs: plan fields (``seed``,
    ``delay_s``, ``corrupt_mode``) or fault entries whose key is
    ``kind:site-glob`` and whose value is a probability or an
    ``@i+j+k`` schedule."""
    fields = {"seed": 0, "delay_s": 0.02, "corrupt_mode": "bitflip"}
    rates: dict = {}
    schedule: dict = {}
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        key, sep, value = entry.partition("=")
        if not sep:
            raise ValueError(f"bad ICIKIT_CHAOS entry {entry!r} "
                             "(expected key=value)")
        key = key.strip()
        value = value.strip()
        if ":" in key:
            if value.startswith("@"):
                schedule[key] = tuple(
                    int(i) for i in value[1:].split("+") if i)
            else:
                rates[key] = float(value)
        elif key == "seed":
            fields["seed"] = int(value)
        elif key == "delay_s":
            fields["delay_s"] = float(value)
        elif key == "corrupt_mode":
            fields["corrupt_mode"] = value
        else:
            raise ValueError(f"unknown ICIKIT_CHAOS field {key!r}")
    return FaultPlan(rates=rates, schedule=schedule, **fields)


_env_spec = os.environ.get("ICIKIT_CHAOS")
if _env_spec:
    _ACTIVE = plan_from_spec(_env_spec)
