"""icikit_torch.obs: the event bus, the metrics registry and host spans.

The parts of ``icikit.obs`` that the fault harness (``icikit_torch.chaos``)
and the checked transport (``icikit_torch.parallel.integrity``) call:
``emit``/``enabled`` and the sinks (:mod:`.bus`), ``count`` and the
registry (:mod:`.metrics`), ``span``/``instant`` and the trace buffer
(:mod:`.tracer`). They are copies of JAX's modules, which are host-only
Python; the tracer's device mirror uses ``torch.profiler.record_function``.
Disabled by default, with JAX's zero-overhead contract: with nothing
armed, every probe is one module-global read and a ``None`` or
truthiness check.

Not ported yet (ROADMAP A11): the Chrome-trace export (``chrome``), the
per-run aggregate (``aggregate``), request traces (``trace_ctx``), the
anomaly watch (``watch``), ``demo``, the scoped ``session`` and the
``ICIKIT_OBS`` environment arming. Tests arm the registry with
``enable_metrics`` / ``disable_metrics`` and read events through a
``RingSink``.
"""

from __future__ import annotations

from icikit_torch.obs.bus import (  # noqa: F401
    FileSink,
    JsonlSink,
    RingSink,
    Sink,
    add_sink,
    dumps_strict,
    emit,
    enabled,
    installed,
    json_safe,
    remove_sink,
)
from icikit_torch.obs.metrics import (  # noqa: F401
    Registry,
    count,
    disable_metrics,
    enable_metrics,
    gauge,
    metrics,
    observe,
)
from icikit_torch.obs.metrics import snapshot as metrics_snapshot  # noqa: F401
from icikit_torch.obs.tracer import (  # noqa: F401
    NOOP_SPAN,
    TraceBuffer,
    instant,
    span,
    start_tracing,
    stop_tracing,
    traced,
    tracing,
)
