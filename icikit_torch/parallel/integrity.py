"""Checked collectives: checksum-carrying schedules with
quarantine-and-retry recovery, ``icikit.parallel.integrity`` on the
port's rank-vectorised transport.

A checked collective runs the *same* registered schedule as its
unchecked twin, but under a transport :class:`~.transport.Tracker`:
every exchanged block travels with an exact bit-fold checksum per rank
row, verified at that step on the device. A run returns, beside the
payload, a (p, n_steps) ``ok`` verdict that stays on the device until
the dispatch boundary drains it once (one device-to-host copy an
attempt); a False entry names the rank and the schedule step that
received the corruption.

Recovery: a detection quarantines the flagged ranks (counters on the obs
bus and a host-side ledger) and reruns the deterministic schedule, at
most ``retries`` times before :class:`IntegrityError`. A retry that
verifies clean is bitwise the run that was never corrupted.

The step count comes first: the chaos taint hash needs ``n_steps``
before attempt 0 (``chaos.traced_corrupt_spec``). JAX reads it from a
trace (``eval_shape``); here :func:`steps_of` runs the schedule once on
``meta`` tensors (shapes only, no data, no kernel, no chaos decision)
under a tracker that only counts, cached per (family, algorithm, p,
shape, dtype, extra).

The ``xla`` variants are refused (PyTorch's op over the rank axis, like
XLA's collective, has no receive step to verify inside), as are the
ragged ``alltoallv`` paths.

Across processes (a mesh split over ``torch.distributed`` processes) a
checked run holds this process's ranks: a remote block crosses with its
checksums and the receiving process folds and compares them. Each
process's verdict rows are gathered before the decision, so every
process sees the whole (p, n_steps) verdict, quarantines the same ranks
and retries together; the chaos plan's decision is a hash of its seed
and call count, the same in every process that arms the same plan.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from icikit_torch import chaos, obs
from icikit_torch.parallel import transport
from icikit_torch.parallel.shmap import family_body, on_mesh, rank_operand
from icikit_torch.utils.mesh import DEFAULT_AXIS

CHECKED_FAMILIES = ("allgather", "allreduce", "alltoall",
                    "reducescatter", "scan")

# every in-schedule corruption site registered at definition: drills
# address "corrupt:collective.<family>"
for _f in CHECKED_FAMILIES:
    chaos.register_site(f"collective.{_f}")


class IntegrityError(RuntimeError):
    """A checked collective kept failing verification past its retry
    budget: persistent corruption, not a transient flip."""


def _require_checkable(family: str, algorithm: str) -> None:
    if algorithm == "xla":
        raise ValueError(
            f"checked {family} cannot run the 'xla' vendor variant: "
            "the vendor collective is one opaque op with no "
            "receive step to verify inside — pick a hand-rolled "
            "schedule (e.g. 'ring')")


def tracked_shard(inner, axis: str):
    """Wrap a schedule body for checked runs: ``per_shard(x, taint)``
    runs ``inner(x)`` under a fresh transport Tracker (every
    ``transport.ppermute`` inside carries and verifies checksums, the
    taint's corruption site armed at its step) and returns ``(out,
    verdict)``, the verdict (p, n_steps) bool on the device. The one
    place the protocol lives (checked collectives here, the bitonic
    exchange network in ``models.sort.bitonic``)."""

    def per_shard(x: torch.Tensor, taint):
        tr = transport.Tracker(axis, taint)
        with transport.checked(tr):
            out = inner(x)
        return out, tr.verdict(x.shape[0], x.device)

    return per_shard


class _StepCounter(transport.Tracker):
    """A tracker that only counts exchanges (the dry run of
    :func:`steps_of`)."""

    def checked_ppermute(self, x, perm):
        self.oks.append(None)
        return transport.plain_ppermute(x, perm)


_STEPS: dict = {}


def steps_of(key: tuple, inner, x: torch.Tensor) -> int:
    """Transport-call count of ``inner`` on operands shaped as ``x``
    (``x`` holding every rank), from a run on ``meta`` tensors under a
    counting tracker and no process view (nothing computed or sent, no
    chaos decision consumed), cached under ``key``."""
    n = _STEPS.get(key)
    if n is None:
        tr = _StepCounter(DEFAULT_AXIS, None)
        with transport.checked(tr), transport.no_view():
            inner(torch.empty(x.shape, dtype=x.dtype, device="meta"))
        n = _STEPS[key] = tr.calls
    return n


def _whole_verdict(ok: torch.Tensor):
    """The (p, n_steps) verdict on the host: this process's rows, or
    under a process view every process's, gathered."""
    view = transport.process_view()
    if view is not None:
        ok = view.all_gather(ok.to(torch.uint8)) != 0
    return ok.cpu().numpy()


# -- quarantine ledger + drill-visible stats -------------------------
# one lock over both: concurrent checked dispatches must not drop
# increments from the ledger a fleet scheduler would read to stop
# leasing work to a defective core

_ledger_lock = threading.Lock()
_QUARANTINE: dict = {}
_STATS = {"detected": 0, "retries": 0, "recoveries": 0, "last": None}


def quarantine_counts() -> dict:
    """Per-rank detection counts (rank -> detections) since the last
    reset: the host-side quarantine ledger beside the ``integrity.*``
    obs counters."""
    with _ledger_lock:
        return dict(_QUARANTINE)


def stats() -> dict:
    with _ledger_lock:
        return {**_STATS, "last": dict(_STATS["last"] or {})}


def reset_stats() -> None:
    with _ledger_lock:
        _QUARANTINE.clear()
        _STATS.update(detected=0, retries=0, recoveries=0, last=None)


def checked_run(site: str, prog, n_steps: int, p: int, args: tuple,
                *, retries: int = 2, label: str = ""):
    """Run a checked program with quarantine-and-retry recovery.

    ``prog(*args, taint) -> (out, ok)``; each attempt consults the armed
    chaos plan afresh (one ``corrupt:<site>`` decision, so a scheduled
    drill fires once and the retry runs clean) and drains ``ok`` once.
    On detection the flagged ranks' counters land on the obs bus, the
    attempt's output is dropped, and the deterministic schedule runs
    again, at most ``retries`` times before :class:`IntegrityError`.
    Under a process view every process decides on the whole verdict.
    """
    label = label or site
    bad = []
    for attempt in range(retries + 1):
        taint = chaos.traced_corrupt_spec(site, n_steps, p)
        out, ok = prog(*args, taint)
        ok_host = _whole_verdict(ok)
        if ok_host.all():
            if attempt:
                with _ledger_lock:
                    _STATS["recoveries"] += 1
                obs.count("integrity.recoveries")
                obs.emit("integrity.recovered", collective=label,
                         attempt=attempt)
            return out
        bad = [(int(d), int(s)) for d, s in np.argwhere(~ok_host)]
        devices = sorted({d for d, _ in bad})
        steps = sorted({s for _, s in bad})
        with _ledger_lock:
            for d in devices:
                _QUARANTINE[d] = _QUARANTINE.get(d, 0) + 1
            _STATS["detected"] += 1
            _STATS["last"] = {"collective": label, "devices": devices,
                              "steps": steps, "attempt": attempt}
            if attempt < retries:
                _STATS["retries"] += 1
        obs.count("integrity.detected")
        obs.count("integrity.quarantined_devices", len(devices))
        obs.emit("integrity.detected", collective=label,
                 devices=devices, steps=steps, attempt=attempt)
        if attempt < retries:
            obs.count("integrity.retries")
    raise IntegrityError(
        f"checked {label} failed verification on ranks "
        f"{sorted({d for d, _ in bad})} in {retries + 1} attempts — "
        "persistent corruption (quarantine ledger: "
        "icikit_torch.parallel.integrity.quarantine_counts())")


def run_checked(family: str, x: torch.Tensor, mesh,
                axis: str = DEFAULT_AXIS, algorithm: str = "ring",
                extra: tuple = (), retries: int = 2) -> torch.Tensor:
    """Checked dispatch for a registered collective family: the verified
    output of the ``algorithm`` schedule over the (p, ...) ``x``, with
    detection and bounded retry at this boundary."""
    _require_checkable(family, algorithm)
    extra = tuple(extra)
    p = mesh.shape[axis]
    inner = family_body(family, algorithm, p, *extra)
    x = rank_operand(family, mesh, axis, x)
    whole = (p,) + tuple(x.shape[1:])
    n_steps = steps_of((family, algorithm, p, whole, x.dtype, extra),
                       inner, torch.empty(whole, dtype=x.dtype,
                                          device="meta"))
    with on_mesh(mesh, axis):
        return checked_run(f"collective.{family}",
                           tracked_shard(inner, axis), n_steps, p, (x,),
                           retries=retries, label=f"{family}/{algorithm}")


# -- the checked twins of the family dispatchers ---------------------


def checked_all_gather(x, mesh, axis: str = DEFAULT_AXIS,
                       algorithm: str = "ring", retries: int = 2):
    return run_checked("allgather", x, mesh, axis, algorithm,
                       retries=retries)


def checked_all_reduce(x, mesh, axis: str = DEFAULT_AXIS,
                       algorithm: str = "ring", op: str = "sum",
                       retries: int = 2):
    return run_checked("allreduce", x, mesh, axis, algorithm,
                       extra=(op,), retries=retries)


def checked_reduce_scatter(x, mesh, axis: str = DEFAULT_AXIS,
                           algorithm: str = "ring", op: str = "sum",
                           retries: int = 2):
    return run_checked("reducescatter", x, mesh, axis, algorithm,
                       extra=(op,), retries=retries)


def checked_all_to_all(x, mesh, axis: str = DEFAULT_AXIS,
                       algorithm: str = "wraparound",
                       retries: int = 2):
    return run_checked("alltoall", x, mesh, axis, algorithm,
                       retries=retries)


def checked_scan(x, mesh, axis: str = DEFAULT_AXIS,
                 algorithm: str = "hillis_steele", op: str = "sum",
                 inclusive: bool = True, retries: int = 2):
    return run_checked("scan", x, mesh, axis, algorithm,
                       extra=(op, bool(inclusive)), retries=retries)
