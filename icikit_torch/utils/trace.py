"""Device activity from a ``torch.profiler`` trace: device time by kernel
name, copies by direction, the busy time and the device's idle share."""

from __future__ import annotations

import json
import os
import re
import tempfile
import time

import torch

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union_us(spans) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def _kernel_key(name: str) -> str:
    """"void (anonymous namespace)::net_kernel<int>(...)" -> net_kernel"""
    return re.match(r"(?:void )?([\w:]*)", name.replace(
        "(anonymous namespace)::", "")).group(1).split("::")[-1]


# host-side calls that put work on the device: a trace that holds any of
# them and no device event lost its device activity
_ENQUEUE = re.compile(r"cu(da)?(Launch|Memcpy|Memset)")


def copy_direction(name: str) -> str:
    """"Memcpy HtoD (Pageable -> Device)" -> "HtoD"; the whole name where
    it names no direction."""
    m = re.match(r"Memcpy (\w+)", name)
    return m.group(1) if m else name


def _correlation(e):
    return (e.get("args") or {}).get("correlation")


def summarize(events, wall_us: float) -> dict:
    """Device activity from a Chrome trace's events: device events
    (kernels, copies, sets) by name, copies by direction, the busy time
    (union of their intervals), and the idle share of the device span
    (first device event to last) and of ``wall_us``.

    ``lost_device_events`` counts the host's enqueue calls (a launch,
    copy or set) whose correlation id no device event carries, and
    ``lost_by_call`` names them (host call name to count): on an H100 a
    short trace can lose some or all of its device records while keeping
    every host call. Raises when it lost all of them, since every number
    here would then read as an idle device."""
    dev = [e for e in events
           if e.get("cat") in _DEVICE_CATS and "dur" in e]
    calls = [e for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and _ENQUEUE.match(e.get("name", ""))]
    enqueued = len(calls)
    seen = {_correlation(e) for e in dev}
    lost_by_call: dict = {}
    for e in calls:
        if _correlation(e) is not None and _correlation(e) not in seen:
            lost_by_call[e["name"]] = lost_by_call.get(e["name"], 0) + 1
    lost = sum(lost_by_call.values())
    if enqueued and not dev:
        raise RuntimeError(
            f"the trace holds {enqueued} host calls that enqueue device "
            "work and no device event")
    by_name: dict = {}
    copies: dict = {}
    for e in dev:
        key = _kernel_key(e["name"])
        c, t = by_name.get(key, (0, 0.0))
        by_name[key] = (c + 1, t + e["dur"])
        if e["cat"] == "gpu_memcpy":
            d = copy_direction(e["name"])
            copies[d] = copies.get(d, 0) + 1
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in dev]
    busy = _union_us(spans)
    span = (max(e for _, e in spans) - min(s for s, _ in spans)
            if spans else 0.0)
    return {"device_events": len(dev), "host_enqueue_calls": enqueued,
            "lost_device_events": lost,
            "lost_by_call": dict(sorted(lost_by_call.items())),
            "by_name": {k: {"count": c, "ms": t / 1e3}
                        for k, (c, t) in sorted(by_name.items())},
            "copies": dict(sorted(copies.items())),
            "busy_ms": busy / 1e3, "device_span_ms": span / 1e3,
            "host_wall_ms": wall_us / 1e3,
            "idle_share_of_span": (1 - busy / span) if span else None,
            "idle_share_of_wall": 1 - busy / wall_us}


def device_activity(run, attempts: int = 1) -> dict:
    """Trace ``run()`` (which should end with all its work enqueued) and
    the synchronise after it, and ``summarize`` the trace; the host's
    wall time runs from the call to the synchronise, profiler overhead
    included. With ``attempts`` > 1, ``run()`` is traced again while a
    trace lost device records, and the first whole trace (or the last)
    is returned, with the number of traces taken."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        try:
            act = summarize(events, wall_us)
        except RuntimeError:
            if attempt == attempts:
                raise
            continue
        if not act["lost_device_events"]:
            break
    return {**act, "attempts": attempt}
