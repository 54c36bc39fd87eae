"""Process-wide metrics registry: counters, gauges, bounded histograms.

Before this module each layer kept its own ad-hoc sums — flush-level
``ServiceTelemetry``, the process-wide ``DispatchStats`` counter, per-search
``ScanStats``/``ShardStats`` — with no single place an operator (or the CI
guard, or the drift tuner) could read. The registry unifies them:

  * native instruments — ``counter``/``gauge``/``histogram`` get-or-create by
    dotted name; histograms are *streaming and bounded* (fixed log-spaced
    bucket boundaries + count/sum/min/max — O(1) memory per observation, so a
    long-lived service's fsync-latency or queue-wait histogram never grows);
  * attached sources — ``attach_source(name, fn)`` folds existing surfaces
    (``ServiceTelemetry.summary``, ``DispatchStats.snapshot``) into the same
    ``snapshot()``/``to_json()`` read path without duplicating their state.

The default registry (``get_registry``) ships with the kernel dispatch
counter pre-attached under ``"dispatch"``; ``obs.profile.enable_profiler``
attaches the dispatch profiler's rollup under ``"profile"`` (and
``disable_profiler`` detaches it). Standard histogram names recorded
by the instrumented layers:

    wal.fsync_s                  fsync latency per group commit (seconds)
    service.queue_wait_s         per-query submit→flush wait (seconds)
    service.flush_size           real queries per flush
    engine.bytes_scanned         arena bytes gathered per flush
    engine.peak_candidate_bytes  candidate merge buffer per flush

All instruments are thread-safe; ``snapshot()`` is a consistent point-in-time
read (each instrument snapshots under its own lock; sources are called
outside any registry lock so a slow source cannot stall recorders).
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import math
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Objective",
    "get_registry",
    "set_registry",
]


class Counter:
    """Monotonically increasing count (thread-safe)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> float:
        return self.value


class Gauge:
    """Last-written value (thread-safe)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> float:
        return self.value


def _default_bounds() -> List[float]:
    # quarter-decade log spacing, 1e-7 .. 1e12: covers microsecond latencies
    # through terabyte byte counts with bounded (< ~35%) quantile error
    return [10.0 ** (e / 4.0) for e in range(-28, 49)]


class Histogram:
    """Streaming histogram over fixed bucket boundaries — bounded memory.

    ``observe`` is O(log #buckets); state is one count per bucket plus
    count/sum/min/max. Quantiles interpolate within the owning bucket, so
    their error is bounded by the bucket width (a quarter decade for the
    default bounds) — the right trade for an always-on serving metric, where
    an exact percentile would need an unbounded (or windowed-and-resorted)
    value log like the one ``ServiceTelemetry`` keeps for latencies only.
    """

    def __init__(self, bounds: Optional[Sequence[float]] = None) -> None:
        b = list(bounds) if bounds is not None else _default_bounds()
        assert b == sorted(b) and len(b) >= 1, "bounds must be ascending"
        self.bounds = b
        self._lock = threading.Lock()
        self._counts = [0] * (len(b) + 1)  # bucket i: value <= bounds[i]; last = overflow
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, x: float) -> None:
        x = float(x)
        i = bisect.bisect_left(self.bounds, x)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += x
            self._min = min(self._min, x)
            self._max = max(self._max, x)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def percentile(self, q: float) -> float:
        """Approximate q-th percentile (q in [0, 100]); 0.0 when empty."""
        with self._lock:
            return self._percentile_locked(q)

    def _percentile_locked(self, q: float) -> float:
        if self._count == 0:
            return 0.0
        rank = q / 100.0 * (self._count - 1)
        seen = 0
        for i, c in enumerate(self._counts):
            if c == 0:
                continue
            if seen + c > rank:
                lo = self.bounds[i - 1] if i > 0 else self._min
                hi = self.bounds[i] if i < len(self.bounds) else self._max
                lo = max(lo, self._min)
                hi = min(hi, self._max)
                if hi <= lo:
                    return lo
                frac = (rank - seen) / c
                return lo + frac * (hi - lo)
            seen += c
        return self._max

    def _snapshot_locked(self) -> Dict[str, float]:
        if self._count == 0:
            return {"count": 0, "sum": 0.0, "mean": 0.0, "min": 0.0,
                    "max": 0.0, "p50": 0.0, "p99": 0.0}
        return {
            "count": self._count,
            "sum": self._sum,
            "mean": self._sum / self._count,
            "min": self._min,
            "max": self._max,
            "p50": self._percentile_locked(50.0),
            "p99": self._percentile_locked(99.0),
        }

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return self._snapshot_locked()

    def to_json(self) -> Dict[str, Any]:
        """Summary fields plus the real distribution.

        ``buckets`` carries the occupied window of the bucket ladder:
        ``le[j]`` is the inclusive upper boundary of bucket ``first + j``
        (``None`` for the overflow bucket beyond the last bound) and
        ``counts[j]`` its occupancy — enough for obsdump / flight bundles to
        render the actual shape, not just interpolated p50/p99.
        """
        with self._lock:
            snap = self._snapshot_locked()
            counts = list(self._counts)
        nz = [i for i, c in enumerate(counts) if c]
        if nz:
            lo, hi = nz[0], nz[-1]
            snap["buckets"] = {
                "first": lo,
                "le": [self.bounds[i] if i < len(self.bounds) else None
                       for i in range(lo, hi + 1)],
                "counts": counts[lo:hi + 1],
            }
        else:
            snap["buckets"] = {"first": 0, "le": [], "counts": []}
        return snap


class MetricsRegistry:
    """Name → instrument map plus attached external snapshot sources."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, Any] = {}
        self._sources: Dict[str, Callable[[], Any]] = {}

    def _get(self, name: str, kind, *args, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = kind(*args, **kw)
            elif not isinstance(m, kind):
                raise TypeError(
                    f"metric {name!r} already registered as {type(m).__name__}"
                )
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, bounds: Optional[Sequence[float]] = None) -> Histogram:
        return self._get(name, Histogram, bounds)

    def attach_source(self, name: str, fn: Callable[[], Any]) -> None:
        """Fold an external surface (e.g. ``telemetry.summary``) into
        ``snapshot()`` under ``name``; re-attaching replaces (latest wins)."""
        with self._lock:
            self._sources[name] = fn

    def detach_source(self, name: str) -> None:
        with self._lock:
            self._sources.pop(name, None)

    def get(self, name: str) -> Optional[Any]:
        """The instrument registered under ``name`` (None when absent) —
        read-only lookups (e.g. ``Objective.evaluate``) must not create."""
        with self._lock:
            return self._metrics.get(name)

    def snapshot(self, detail: bool = False) -> Dict[str, Any]:
        """One consistent read of every instrument and attached source.

        ``detail=True`` expands histograms via ``Histogram.to_json`` (bucket
        boundaries + counts) — the form flight bundles persist.
        """
        with self._lock:
            metrics = dict(self._metrics)
            sources = dict(self._sources)
        out: Dict[str, Any] = {
            name: (m.to_json() if detail and isinstance(m, Histogram)
                   else m.snapshot())
            for name, m in sorted(metrics.items())
        }
        for name, fn in sorted(sources.items()):
            try:
                out[name] = fn()
            except Exception as e:  # a dead source must not poison the read
                out[name] = {"error": repr(e)}
        return out

    def to_json(self, indent: Optional[int] = None, detail: bool = False) -> str:
        return json.dumps(self.snapshot(detail=detail), indent=indent,
                          default=_jsonable)


@dataclasses.dataclass(frozen=True)
class Objective:
    """Declarative SLO over one registry instrument.

    ``metric`` names a registered instrument; for histograms ``stat`` picks
    the snapshot statistic (``p50``/``p99``/``mean``/``max``/``min``), for
    counters/gauges use ``stat="value"``. ``evaluate`` returns a human-
    readable breach description when the objective is violated, else None —
    the flight recorder's slo_burn rule dumps an incident on the None→breach
    edge. ``min_count`` suppresses evaluation until a histogram has seen
    enough samples (no breach on the first slow warmup call).
    """

    name: str
    metric: str
    stat: str = "p99"
    max_value: Optional[float] = None
    min_value: Optional[float] = None
    min_count: int = 1

    def evaluate(self, registry: Optional["MetricsRegistry"] = None) -> Optional[str]:
        reg = get_registry() if registry is None else registry
        inst = reg.get(self.metric)
        if inst is None:
            return None
        if isinstance(inst, Histogram):
            s = inst.snapshot()
            if s["count"] < self.min_count:
                return None
            v = s.get(self.stat)
            if v is None:
                return None
        else:
            v = inst.value
        if self.max_value is not None and v > self.max_value:
            return (f"{self.name}: {self.metric}.{self.stat}={v:.6g} "
                    f"> max {self.max_value:.6g}")
        if self.min_value is not None and v < self.min_value:
            return (f"{self.name}: {self.metric}.{self.stat}={v:.6g} "
                    f"< min {self.min_value:.6g}")
        return None


def _jsonable(o: Any) -> Any:
    try:
        import numpy as np

        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, np.generic):
            return o.item()
    except ImportError:  # pragma: no cover
        pass
    if isinstance(o, set):
        return sorted(map(str, o))
    return str(o)


# ---------------------------------------------------------------------------
# Process-wide default registry
# ---------------------------------------------------------------------------

_REGISTRY: Optional[MetricsRegistry] = None
_REG_LOCK = threading.Lock()


def _dispatch_source() -> Dict[str, Any]:
    from ..kernels import ops as kops  # lazy: keep obs import-light

    st = kops.dispatch_stats().snapshot()
    return {
        "knn_calls": st.knn_calls,
        "merge_calls": st.merge_calls,
        "distinct_shapes": len(st.shapes),
        "peak_candidate_bytes": st.peak_candidate_bytes,
        "lut_expand_bytes": st.lut_expand_bytes,
    }


def get_registry() -> MetricsRegistry:
    """The process-wide registry (created on first use, ``dispatch``
    pre-attached so kernel-dispatch accounting shows up with no wiring)."""
    global _REGISTRY
    with _REG_LOCK:
        if _REGISTRY is None:
            _REGISTRY = MetricsRegistry()
            _REGISTRY.attach_source("dispatch", _dispatch_source)
        return _REGISTRY


def set_registry(reg: Optional[MetricsRegistry]) -> MetricsRegistry:
    """Swap the process-wide registry (tests isolate with a fresh one);
    ``None`` installs a fresh default. Returns the active registry."""
    global _REGISTRY
    with _REG_LOCK:
        _REGISTRY = reg
    return get_registry()
