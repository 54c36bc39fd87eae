"""Observability: the span tracer, the metrics registry, the drift monitor.

  * ``obs.trace`` — process-wide span tracer exporting Chrome-trace JSON
    (Perfetto-loadable); disabled by default via a free ``NullTracer``.
  * ``obs.metrics`` — counters/gauges/bounded-histograms registry unifying
    the layers' ad-hoc stats behind one ``snapshot()``/``to_json()``, plus
    declarative ``Objective`` SLOs evaluated against registry instruments.
  * ``obs.drift`` — sliding-window workload monitor emitting the
    ``DriftReport`` a hot-swap index tuner consumes.

The dispatch profiler and the flight recorder wait for their item
(ROADMAP.md §1, ``obs/profile.py``). This package is imported by hot
serving paths: numpy at module level only; the engine loads lazily.
"""
from .drift import DriftConfig, DriftMonitor, DriftReport
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Objective,
    get_registry,
    set_registry,
)
from .trace import (
    NullTracer,
    Tracer,
    disable,
    enable,
    fence,
    get_tracer,
    get_thread_name,
    set_thread_name,
    set_tracer,
    validate_chrome_trace,
)

__all__ = [
    "DriftConfig",
    "DriftMonitor",
    "DriftReport",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Objective",
    "get_registry",
    "set_registry",
    "NullTracer",
    "Tracer",
    "disable",
    "enable",
    "fence",
    "get_tracer",
    "get_thread_name",
    "set_thread_name",
    "set_tracer",
    "validate_chrome_trace",
]
