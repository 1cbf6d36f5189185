"""Device activity from a ``torch.profiler`` trace: device time by kernel
name, the busy time and the device's idle share."""

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


def device_activity(run) -> dict:
    """Trace ``run()`` (which should end with all its work enqueued) and
    the synchronise after it: device events (kernels, copies, sets) by
    name, the busy time (union of their intervals), and the idle share
    of the device span (first device event to last) and of the host's
    wall time (the call to the synchronise, profiler overhead
    included)."""
    from torch.profiler import ProfilerActivity, profile

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
    dev = [e for e in events
           if e.get("cat") in _DEVICE_CATS and "dur" in e]
    by_name: dict = {}
    for e in dev:
        key = _kernel_key(e["name"])
        c, t = by_name.get(key, (0, 0.0))
        by_name[key] = (c + 1, t + e["dur"])
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in dev]
    busy = _union_us(spans)
    span = (max(e for _, e in spans) - min(s for s, _ in spans)
            if spans else 0.0)
    return {"device_events": len(dev),
            "by_name": {k: {"count": c, "ms": t / 1e3}
                        for k, (c, t) in sorted(by_name.items())},
            "busy_ms": busy / 1e3, "device_span_ms": span / 1e3,
            "host_wall_ms": wall_us / 1e3,
            "idle_share_of_span": (1 - busy / span) if span else None,
            "idle_share_of_wall": 1 - busy / wall_us}
