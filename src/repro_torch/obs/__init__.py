"""Observability: tracing, metrics, drift, the dispatch profiler, the
flight recorder.

  * ``obs.trace`` — process-wide span tracer exporting Chrome-trace JSON
    (Perfetto-loadable); disabled by default via a free ``NullTracer``.
  * ``obs.metrics`` — counters/gauges/bounded-histograms registry unifying
    the layers' ad-hoc stats behind one ``snapshot()``/``to_json()``, plus
    declarative ``Objective`` SLOs evaluated against registry instruments.
  * ``obs.drift`` — sliding-window workload monitor emitting the
    ``DriftReport`` a hot-swap index tuner consumes.
  * ``obs.profile`` — kernel-grained dispatch profiler attributing device
    time to plan-derived bytes/FLOPs against ``launch.roofline`` hardware
    terms; disabled by default via a free ``NullProfiler``.
  * ``obs.flight`` — always-on bounded flight recorder dumping atomic
    postmortem incident bundles when declarative trigger rules fire.

This package is imported by hot serving paths: numpy at module level only;
torch and the engine load lazily inside functions.
"""
from .drift import DriftConfig, DriftMonitor, DriftReport
from .flight import (
    FlightRecorder,
    FlightSample,
    TriggerRule,
    default_rules,
    slo_rule,
    validate_incident_bundle,
)
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Objective,
    get_registry,
    set_registry,
)
from .profile import (
    KernelProfiler,
    NullProfiler,
    disable_profiler,
    enable_profiler,
    get_profiler,
    set_profiler,
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
    "FlightRecorder",
    "FlightSample",
    "TriggerRule",
    "default_rules",
    "slo_rule",
    "validate_incident_bundle",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Objective",
    "get_registry",
    "set_registry",
    "KernelProfiler",
    "NullProfiler",
    "disable_profiler",
    "enable_profiler",
    "get_profiler",
    "set_profiler",
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
