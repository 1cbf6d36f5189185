"""icikit_torch.chaos and icikit_torch.obs against the JAX package's.

The port keeps its own copy of ``icikit.chaos`` (host-only Python) over
its own obs bus. One plan must fire at the same call indices in both
packages: the fired logs over a probe sequence, the taint vectors of
``traced_corrupt_spec``, ``plan_from_spec`` and the decision hash are
held equal, exactly. The obs copies keep JAX's contracts (strict JSON,
the registry's snapshot, spans and instants).
"""

from __future__ import annotations

import json
import math

import numpy as np
import pytest

from icikit import chaos as j_chaos
from icikit import obs as j_obs
from icikit_torch import chaos, obs
from icikit_torch.parallel import integrity  # noqa: F401 (registers sites)

SITES = ("collective.allgather", "collective.allreduce", "sort.bitonic",
         "sort.bitonic.exchange", "solitaire.worker.3", "train.ckpt.save")
SPECS = ("seed=7;die:solitaire.worker.*=0.25;io:train.ckpt.*=@1+3",
         "seed=3;corrupt:collective.*=0.5;delay_s=0.01;corrupt_mode=nan",
         "corrupt:sort.bitonic.exchange=@0;delay:sort.*=1.0")


def _probe_log(mod, plan_kw, calls):
    plan = mod.FaultPlan(**plan_kw)
    fired = [plan.fires(kind, site) for kind, site in calls]
    return fired, sorted(plan.log)


@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
def test_fault_plan_fires_the_same_calls(seed):
    rng = np.random.default_rng(seed)
    calls = [(chaos.KINDS[int(rng.integers(4))],
              SITES[int(rng.integers(len(SITES)))]) for _ in range(400)]
    plan_kw = dict(seed=seed,
                   rates={"corrupt:collective.*": 0.3, "die:sort.*": 0.1,
                          "delay:*": 0.05, "io:train.ckpt.*": 0.5},
                   schedule={"die:solitaire.worker.3": (0, 2, 5),
                             "corrupt:sort.bitonic.exchange": (1,)})
    assert _probe_log(chaos, plan_kw, calls) == \
        _probe_log(j_chaos, plan_kw, calls)


def test_decision_hash_is_jax_s():
    for parts in ((0, "corrupt", "collective.allgather", 0),
                  (7, "corrupt-loc", "sort.bitonic.exchange", 12),
                  ("x", 1.5, None)):
        assert chaos._u64(*parts) == j_chaos._u64(*parts)


@pytest.mark.parametrize("seed", [0, 5, 21])
def test_traced_corrupt_spec_gives_the_same_taints(seed):
    rows = []
    for mod in (chaos, j_chaos):
        plan = mod.FaultPlan(seed=seed,
                             rates={"corrupt:collective.*": 0.6},
                             schedule={"corrupt:sort.bitonic.exchange":
                                       (0, 3)})
        out = []
        with mod.inject(plan):
            for i in range(40):
                site = SITES[i % 4]
                n_steps, p = (i % 7) + 1, (i % 8) + 1
                out.append(mod.traced_corrupt_spec(site, n_steps, p))
        rows.append((np.stack(out), sorted(plan.log)))
    (tv, tl), (jv, jl) = rows
    assert tv.dtype == jv.dtype == np.int32
    assert np.array_equal(tv, jv) and tl == jl
    assert (tv[:, 0] >= 0).any() and (tv[:, 0] < 0).any()


def test_cold_spec_and_no_exchange_warning_match():
    assert np.array_equal(chaos.traced_corrupt_spec("collective.scan", 3, 4),
                          chaos.TAINT_OFF)
    assert np.array_equal(chaos.TAINT_OFF, j_chaos.TAINT_OFF)
    plan = chaos.FaultPlan(schedule={"corrupt:collective.scan": (0,)})
    with chaos.inject(plan), pytest.warns(RuntimeWarning,
                                          match="no exchange steps"):
        out = chaos.traced_corrupt_spec("collective.scan", 0, 1)
    assert np.array_equal(out, chaos.TAINT_OFF) and plan.log


@pytest.mark.parametrize("spec", SPECS)
def test_plan_from_spec_matches(spec):
    a, b = chaos.plan_from_spec(spec), j_chaos.plan_from_spec(spec)
    for f in ("seed", "rates", "schedule", "delay_s", "corrupt_mode"):
        assert getattr(a, f) == getattr(b, f)
    with pytest.raises(ValueError):
        chaos.plan_from_spec("bogus=1")
    with pytest.raises(ValueError, match="unknown fault kind"):
        chaos.FaultPlan(rates={"melt:x": 1.0})


def test_host_probes_and_io_retry():
    plan = chaos.FaultPlan(schedule={"die:drill_a": (1,), "io:drill_io": (0, 1)},
                           delay_s=0.0)
    with chaos.inject(plan):
        chaos.maybe_die("drill_a")
        with pytest.raises(chaos.InjectedDeath):
            chaos.maybe_die("drill_a")
        calls = []
        assert chaos.io_retry("drill_io", lambda: calls.append(1) or 5,
                              first_backoff=0.0) == 5
    assert calls == [1] and plan.fired("io") == 2
    assert chaos.active() is None


def test_inject_warns_on_a_typo_beside_a_registered_site():
    plan = chaos.FaultPlan(
        rates={"die:collective.allgatherr": 0.5})  # chaos-site-lint: off
    with pytest.warns(RuntimeWarning, match="no registered probe site"):
        with chaos.inject(plan):
            pass


def test_probe_events_match_jax_s():
    """Every decision is an event on the bus, the same in both."""
    evs = []
    for mod, o in ((chaos, obs), (j_chaos, j_obs)):
        ring = o.RingSink()
        plan = mod.FaultPlan(seed=2, rates={"delay:sort.*": 0.5},
                             delay_s=0.0)
        with o.installed(ring), mod.inject(plan):
            for _ in range(12):
                mod.maybe_delay("sort.bitonic")
        evs.append(ring.events)
    assert evs[0] == evs[1] and len(evs[0]) == 12


# -- obs ---------------------------------------------------------------


def test_bus_is_strict_json_and_disabled_by_default():
    assert not obs.enabled()
    obs.emit("nothing")   # no sink: returns at once
    ring = obs.RingSink()
    with obs.installed(ring):
        assert obs.enabled()
        obs.emit("x", v=math.nan, n=[1, math.inf])
        obs.emit(None, step=3)
    assert not obs.enabled()
    assert ring.of_type("x") == [{"event": "x", "v": math.nan,
                                  "n": [1, math.inf]}]
    line = obs.dumps_strict(ring.events[0])
    assert json.loads(line) == {"event": "x", "v": "nan",
                                "n": [1, "inf"]}
    assert line == j_obs.dumps_strict(ring.events[0])
    assert ring.events[1] == {"step": 3}


def test_metrics_registry_and_counters():
    assert obs.metrics() is None
    obs.count("a")       # disabled: nothing to count into
    reg = obs.enable_metrics()
    try:
        obs.count("a")
        obs.count("a", 2)
        obs.count("b", 0)
        obs.gauge("g", 1.5)
        for v in range(100):
            obs.observe("h", v)
        snap = reg.snapshot()
    finally:
        assert obs.disable_metrics() is reg
    assert snap["counters"] == {"a": 3, "b": 0}
    assert snap["gauges"] == {"g": 1.5}
    h = snap["histograms"]["h"]
    assert (h["count"], h["min"], h["max"], h["p50"]) == (100, 0.0, 99.0,
                                                          50.0)


def test_spans_and_instants():
    assert obs.span("x") is obs.NOOP_SPAN
    tb = obs.start_tracing()
    try:
        with obs.span("outer", k=1):
            with obs.span("inner"):
                obs.instant("tick", a=2)
    finally:
        assert obs.stop_tracing() is tb
    ev = [e for e in tb.snapshot() if e["ph"] != "M"]
    assert [(e["ph"], e["name"]) for e in ev] == [
        ("B", "outer"), ("B", "inner"), ("i", "tick"), ("E", "inner"),
        ("E", "outer")]
    assert ev[1]["args"]["parent"] == ev[0]["args"]["trace_id"]
    mirrored = obs.TraceBuffer(mirror_device=True)
    assert mirrored.mirror_device and mirrored._annotation_cls is not None
