"""Lightweight end-to-end query tracing (Chrome-trace / Perfetto export).

One process-wide tracer (``get_tracer``/``set_tracer``) that every layer of
the serving stack reports into: the service records flush/queue-wait/WAL
spans, ``core.planner`` records per-bucket kernel dispatches and merges,
the store records snapshot writes/loads and fsyncs. Spans nest by
thread (a thread-local stack tracks the enclosing span), use the monotonic
``time.perf_counter_ns`` clock — the SAME clock the service stamps
``QueryHandle.t_submit`` with, so retroactive spans (``add_span``) can cover
submit→flush queue waits exactly — and land in a bounded ring buffer, so a
long-lived service never grows memory with uptime.

``export(path)`` writes Chrome-trace JSON (the ``traceEvents`` array format)
that loads directly in Perfetto / chrome://tracing; ``validate_chrome_trace``
is the schema check shared by the tests and the CI guard.

Cost discipline: the default tracer is a ``NullTracer`` singleton whose
``span`` returns one shared no-op context manager — no event objects, no
ring-buffer traffic, nothing retained — so instrumentation left in hot paths
is free until an operator calls ``enable()``. Device-time honesty: span
bodies that launch asynchronous CUDA work call ``fence(...)`` before closing,
which synchronizes the device ONLY when tracing (or the dispatch profiler,
``obs.profile``) is enabled, so dispatch
spans measure real device time without perturbing the untraced fast path.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = [
    "Tracer",
    "NullTracer",
    "get_tracer",
    "set_tracer",
    "enable",
    "disable",
    "fence",
    "set_thread_name",
    "get_thread_name",
    "validate_chrome_trace",
]


# ---------------------------------------------------------------------------
# Thread labels: background loops (service scheduler, compactor, tuner,
# flight recorder) call set_thread_name() once at the top of their loop; the
# tracer stamps the label on every ROOT span that thread opens (nested spans
# already carry a parent chain) and emits one Chrome "M" thread_name
# metadata event per thread, so incident bundles can tell background work
# from request work in Perfetto.
# ---------------------------------------------------------------------------

_THREAD_CTX = threading.local()


def set_thread_name(name: Optional[str]) -> None:
    """Label the calling thread's future root spans (None clears it)."""
    _THREAD_CTX.name = None if name is None else str(name)


def get_thread_name() -> Optional[str]:
    return getattr(_THREAD_CTX, "name", None)


class _NullSpan:
    """Shared no-op context manager returned by ``NullTracer.span``."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: every call is a no-op, nothing is ever recorded."""

    enabled = False

    def span(self, name: str, **args) -> _NullSpan:
        return _NULL_SPAN

    def add_span(self, name: str, t0_s: float, t1_s: float, **args) -> None:
        pass

    def instant(self, name: str, **args) -> None:
        pass

    def counter(self, name: str, value: float) -> None:
        pass

    @property
    def span_count(self) -> int:
        return 0

    def events(self) -> List[dict]:
        return []

    def reset(self) -> None:
        pass

    def export(self, path: str) -> str:
        doc = {"traceEvents": [], "displayTimeUnit": "ms"}
        with open(path, "w") as f:
            json.dump(doc, f)
        return path


class _Span:
    """Context manager recording one duration event on exit."""

    __slots__ = ("tracer", "name", "args", "t0", "tid", "parent")

    def __init__(self, tracer: "Tracer", name: str, args: Dict[str, Any]) -> None:
        self.tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self) -> "_Span":
        stack = self.tracer._stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.tid = threading.get_ident()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        stack = self.tracer._stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        self.tracer._record(self.name, self.t0, t1, self.tid, self.parent, self.args)
        return False


class Tracer:
    """Ring-buffered span recorder exporting Chrome-trace JSON.

    Thread-safe: spans may open/close concurrently on the scheduler thread,
    writer threads, and foreground callers; each completed span appends one
    event under the lock. ``capacity`` bounds retained events (oldest spans
    evict first); ``span_count`` keeps the lifetime total so tests can assert
    activity even after eviction.
    """

    enabled = True

    def __init__(self, capacity: int = 65_536) -> None:
        assert capacity >= 1
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._head = 0  # ring cursor once the buffer is full
        self._count = 0
        self._local = threading.local()
        self._named_tids: set = set()  # tids with a thread_name "M" event
        # epoch for relative timestamps: the same perf_counter clock the
        # service uses, so add_span can take raw perf_counter floats
        self._t0_ns = time.perf_counter_ns()

    # --------------------------------------------------------------- recording

    def _stack(self) -> List[str]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def span(self, name: str, **args) -> _Span:
        """``with tracer.span("flush.dispatch", bucket=...):`` — one event."""
        return _Span(self, name, args)

    def _record(
        self,
        name: str,
        t0_ns: int,
        t1_ns: int,
        tid: int,
        parent: Optional[str],
        args: Dict[str, Any],
    ) -> None:
        ev = {
            "name": name,
            "ph": "X",
            "ts": (t0_ns - self._t0_ns) / 1e3,  # Chrome trace wants microseconds
            "dur": max(0.0, (t1_ns - t0_ns) / 1e3),
            "pid": 1,
            "tid": tid,
        }
        meta = None
        if parent is not None:
            args = dict(args, parent=parent)
        else:
            label = getattr(_THREAD_CTX, "name", None)
            if label is not None:
                args = dict(args, thread=label)
                if tid not in self._named_tids:
                    meta = {
                        "name": "thread_name",
                        "ph": "M",
                        "ts": 0.0,
                        "pid": 1,
                        "tid": tid,
                        "args": {"name": label},
                    }
        if args:
            ev["args"] = args
        with self._lock:
            if meta is not None and tid not in self._named_tids:
                self._named_tids.add(tid)
                if len(self._events) < self.capacity:
                    self._events.append(meta)
                else:
                    self._events[self._head] = meta
                    self._head = (self._head + 1) % self.capacity
                self._count += 1
            if len(self._events) < self.capacity:
                self._events.append(ev)
            else:  # ring: overwrite the oldest slot
                self._events[self._head] = ev
                self._head = (self._head + 1) % self.capacity
            self._count += 1

    def add_span(self, name: str, t0_s: float, t1_s: float, **args) -> None:
        """Record a span retroactively from two ``time.perf_counter()`` stamps
        (e.g. a query's submit→flush queue wait, known only at flush time)."""
        self._record(
            name,
            int(t0_s * 1e9),
            int(t1_s * 1e9),
            threading.get_ident(),
            None,
            args,
        )

    def instant(self, name: str, **args) -> None:
        """Point-in-time marker (Chrome-trace instant event)."""
        ev = {
            "name": name,
            "ph": "i",
            "ts": (time.perf_counter_ns() - self._t0_ns) / 1e3,
            "pid": 1,
            "tid": threading.get_ident(),
            "s": "t",
        }
        if args:
            ev["args"] = args
        with self._lock:
            if len(self._events) < self.capacity:
                self._events.append(ev)
            else:
                self._events[self._head] = ev
                self._head = (self._head + 1) % self.capacity
            self._count += 1

    def counter(self, name: str, value: float) -> None:
        """Chrome-trace counter sample (renders as a track in Perfetto)."""
        ev = {
            "name": name,
            "ph": "C",
            "ts": (time.perf_counter_ns() - self._t0_ns) / 1e3,
            "pid": 1,
            "tid": threading.get_ident(),
            "args": {"value": float(value)},
        }
        with self._lock:
            if len(self._events) < self.capacity:
                self._events.append(ev)
            else:
                self._events[self._head] = ev
                self._head = (self._head + 1) % self.capacity
            self._count += 1

    # ----------------------------------------------------------------- reading

    @property
    def span_count(self) -> int:
        """Lifetime number of recorded events (survives ring eviction)."""
        with self._lock:
            return self._count

    def events(self) -> List[dict]:
        """Retained events, oldest first (a consistent copy)."""
        with self._lock:
            return self._events[self._head:] + self._events[: self._head]

    def reset(self) -> None:
        with self._lock:
            self._events = []
            self._head = 0
            self._count = 0

    # ------------------------------------------------------------------ export

    def to_chrome_trace(self) -> dict:
        """The Chrome-trace document (``traceEvents`` array format)."""
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def export(self, path: str) -> str:
        """Write the trace as Chrome-trace JSON viewable in Perfetto."""
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path


# ---------------------------------------------------------------------------
# Process-wide tracer (default: disabled)
# ---------------------------------------------------------------------------

_NULL = NullTracer()
_TRACER = _NULL


def get_tracer():
    """The process-wide tracer every instrumented layer reports to."""
    return _TRACER


def set_tracer(tracer) -> None:
    global _TRACER
    _TRACER = _NULL if tracer is None else tracer


def enable(capacity: int = 65_536) -> Tracer:
    """Install (and return) a fresh recording tracer."""
    t = Tracer(capacity=capacity)
    set_tracer(t)
    return t


def disable() -> None:
    """Back to the free no-op tracer."""
    set_tracer(_NULL)


# The KernelProfiler needs fenced dispatch timings even when no tracer is
# installed (profiling without the trace ring): obs.profile sets this hold
# on enable so fence() still synchronizes for real device time.
_FENCE_HOLD = False


def _set_fence_hold(on: bool) -> None:
    global _FENCE_HOLD
    _FENCE_HOLD = bool(on)


def fence(*tensors):
    """``torch.cuda.synchronize()`` IFF tracing or profiling is enabled and a
    value lives on a CUDA device.

    Dispatch sites call this inside their span so the recorded duration is
    real device time, not launch time; with the NullTracer installed (and no
    profiler) it is a no-op and the asynchronous stream is untouched.
    """
    if (_TRACER.enabled or _FENCE_HOLD) and any(getattr(t, "is_cuda", False) for t in tensors):
        import torch

        torch.cuda.synchronize()
    return tensors[0] if len(tensors) == 1 else tensors


# ---------------------------------------------------------------------------
# Schema validation (shared by tests and the CI trace guard)
# ---------------------------------------------------------------------------

_REQUIRED = {"name", "ph", "ts", "pid", "tid"}
_PHASES = {"X", "i", "I", "C", "M", "b", "e", "B", "E"}


def validate_chrome_trace(doc: Any) -> int:
    """Validate a Chrome-trace document; returns the event count.

    Checks the contract Perfetto's importer relies on: a ``traceEvents``
    array (or a bare array) of events each carrying name/ph/ts/pid/tid,
    known phase codes, non-negative durations on complete events, and JSON-
    serializable args. Raises ``ValueError`` with the offending event index.
    """
    if isinstance(doc, dict):
        events = doc.get("traceEvents")
        if not isinstance(events, list):
            raise ValueError("trace document has no 'traceEvents' array")
    elif isinstance(doc, list):
        events = doc
    else:
        raise ValueError(f"not a trace document: {type(doc).__name__}")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i} is not an object")
        missing = _REQUIRED - set(ev)
        if missing:
            raise ValueError(f"event {i} missing fields {sorted(missing)}")
        if not isinstance(ev["name"], str) or not ev["name"]:
            raise ValueError(f"event {i} has a non-string/empty name")
        if ev["ph"] not in _PHASES:
            raise ValueError(f"event {i} has unknown phase {ev['ph']!r}")
        if not isinstance(ev["ts"], (int, float)):
            raise ValueError(f"event {i} has non-numeric ts")
        if ev["ph"] == "X":
            if not isinstance(ev.get("dur"), (int, float)) or ev["dur"] < 0:
                raise ValueError(f"event {i} ('X') needs a non-negative dur")
        if "args" in ev and not isinstance(ev["args"], dict):
            raise ValueError(f"event {i} args is not an object")
    return len(events)
