"""Observability for the live search path: tracing + metrics, zero deps.

The paper's value claim is operational — fewer k's visited, in-flight work
aborted, bounds shared across resources — so the reproduction carries a
search-wide telemetry layer that turns those claims into measurable spans
and counters on *live* runs, not just the offline ``SimulatedScheduler``:

  * ``repro_torch.obs.trace`` — ``Tracer`` (nested spans + instant events,
    thread-safe, exportable as JSONL and Chrome-trace/Perfetto JSON) and
    the allocation-free ``NullTracer`` default.
  * ``repro_torch.obs.metrics`` — a process-local registry of counters / gauges /
    histograms whose ``summary()`` derives the paper's headline number
    (visit fraction vs. naive grid search) from live accounting.

Every instrumented component resolves the process defaults at call time
(``get_tracer()`` / ``get_metrics()``), so enabling telemetry is one
``set_tracer(Tracer())`` (or the ``use_tracer`` context manager / the
``ksearch --trace`` flag) — no constructor plumbing, and the hot path pays
a single attribute read when tracing is off.
"""
from .metrics import (  # noqa: F401
    Metrics,
    get_metrics,
    set_metrics,
    use_metrics,
)
from .trace import (  # noqa: F401
    NULL_TRACER,
    NullTracer,
    Tracer,
    get_tracer,
    set_tracer,
    use_tracer,
)

__all__ = [
    "Tracer",
    "NullTracer",
    "NULL_TRACER",
    "get_tracer",
    "set_tracer",
    "use_tracer",
    "Metrics",
    "get_metrics",
    "set_metrics",
    "use_metrics",
]
