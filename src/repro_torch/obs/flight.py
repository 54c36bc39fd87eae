"""SLO-triggered flight recorder: an always-on black box for serving.

Tracing and the metrics registry are *pull*: an operator enables tracing,
runs traffic, reads the export. Incidents don't wait for an operator. The
``FlightRecorder`` keeps a bounded black box running next to an
``HQIService`` — recent spans (it installs a bounded ``Tracer`` if none is
active), metric snapshots, recent flush records, health transitions — and
polls a set of declarative ``TriggerRule``s. When a rule trips it atomically
dumps a postmortem bundle to a bounded on-disk ring of incident directories:

    incidents/
      incident-0001-flush_crash/
        manifest.json   schema, seq, tripped rules + detail, health + recent
                        transitions, telemetry summary, recent flush records,
                        armed failpoints, CURRENT generation pointer
        trace.json      Chrome-trace export of the retained span ring (the
                        offending window — validate_chrome_trace-clean)
        metrics.json    registry snapshot with full histogram buckets
        profile.json    KernelProfiler report (``{"enabled": false}`` when
                        profiling is off)

The bundle's schema is the reference's, key for key
(``repro.obs.flight``), so each package's ``validate_incident_bundle``
accepts the other's bundles.

Built-in rules are *edge-triggered* on (prev, cur) observation pairs —
flush crash (``flush_failures`` delta), index swap, deadline spike,
``health()`` leaving ``ok`` — plus ``slo_rule`` wrapping an
``obs.metrics.Objective`` (latency/recall SLOs), which fires once per
continuous breach. Every rule also has a cooldown, and one ``observe()``
dumps at most one bundle listing every rule that tripped — so a single
incident produces a single bundle, never a dump storm.

Bundles publish via tmp-dir + ``os.rename`` (atomic: a crash mid-dump never
leaves a half-readable incident) and the ring prunes oldest-first beyond
``max_incidents``; a recorder opened on an existing ring resumes its
sequence numbers. ``validate_incident_bundle`` is the schema check shared
by the tests and the on-card smoke.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import trace as _trace
from .metrics import Objective, get_registry
from .profile import get_profiler

__all__ = [
    "FlightRecorder",
    "FlightSample",
    "TriggerRule",
    "default_rules",
    "slo_rule",
    "validate_incident_bundle",
    "INCIDENT_SCHEMA",
]

INCIDENT_SCHEMA = "hqi-incident-v1"

_MANIFEST_REQUIRED = {
    "schema",
    "seq",
    "rules",
    "detail",
    "t_unix",
    "health",
    "telemetry",
    "health_transitions",
    "recent_flushes",
    "armed_failpoints",
    "current_generation",
}

_BUNDLE_FILES = ("manifest.json", "trace.json", "metrics.json", "profile.json")


@dataclasses.dataclass
class FlightSample:
    """One poll's view of the service: health rollup + telemetry summary."""

    t: float  # perf_counter seconds
    health: Dict[str, Any]
    telemetry: Dict[str, float]


@dataclasses.dataclass(frozen=True)
class TriggerRule:
    """Edge-triggered incident predicate over (prev, cur) samples.

    ``check(prev, cur)`` returns a human-readable detail string to trip, or
    None. ``cooldown_s`` suppresses re-firing of the SAME rule while the
    condition persists across polls.
    """

    name: str
    check: Callable[[FlightSample, FlightSample], Optional[str]]
    cooldown_s: float = 5.0


def _delta_rule(name: str, key: str, threshold: float = 1.0) -> TriggerRule:
    def check(prev: FlightSample, cur: FlightSample) -> Optional[str]:
        d = cur.telemetry.get(key, 0.0) - prev.telemetry.get(key, 0.0)
        if d >= threshold:
            return f"{key} +{d:g} in one poll (threshold {threshold:g})"
        return None

    return TriggerRule(name, check)


def _health_rule() -> TriggerRule:
    def check(prev: FlightSample, cur: FlightSample) -> Optional[str]:
        was, now = prev.health.get("status"), cur.health.get("status")
        if was == "ok" and now != "ok":
            return f"health left ok: {was} -> {now}"
        return None

    return TriggerRule("health", check)


def slo_rule(obj: Objective, cooldown_s: float = 30.0) -> TriggerRule:
    """Objective → rule, firing once per *continuous* breach: histograms are
    lifetime-cumulative, so a breached p99 stays breached — without the
    edge-tracking here every poll past the cooldown would re-dump."""
    state = {"breached": False}

    def check(prev: FlightSample, cur: FlightSample) -> Optional[str]:
        detail = obj.evaluate()
        if detail is None:
            state["breached"] = False
            return None
        if state["breached"]:
            return None
        state["breached"] = True
        return detail

    return TriggerRule(f"slo:{obj.name}", check, cooldown_s)


def default_rules(
    objectives: Sequence[Objective] = (), deadline_spike: int = 8
) -> List[TriggerRule]:
    """The built-in trigger matrix: flush crash, index swap, deadline spike,
    health leaving ok, plus one slo_rule per objective."""
    rules = [
        _delta_rule("flush_crash", "flush_failures"),
        _delta_rule("index_swap", "index_swaps"),
        _delta_rule("deadline_spike", "deadline_expired", float(deadline_spike)),
        _health_rule(),
    ]
    rules.extend(slo_rule(o) for o in objectives)
    return rules


class FlightRecorder:
    """Bounded black box + trigger rules + atomic incident bundles.

    Drive it manually (``observe()`` per poll — what the tests do for
    determinism) or with ``start()``/``stop()`` for the background daemon
    (thread-labeled ``flight``). ``force(reason)`` dumps unconditionally.
    """

    def __init__(
        self,
        service,
        root: str,
        *,
        rules: Optional[Sequence[TriggerRule]] = None,
        objectives: Sequence[Objective] = (),
        max_incidents: int = 8,
        poll_s: float = 0.05,
        trace_capacity: int = 16_384,
        store_root: Optional[str] = None,
        history: int = 64,
    ) -> None:
        self.service = service
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.rules = list(rules) if rules is not None else default_rules(objectives)
        self.max_incidents = int(max_incidents)
        self.poll_s = float(poll_s)
        self.trace_capacity = int(trace_capacity)
        self.store_root = store_root
        self.incidents_written = 0
        self._lock = threading.Lock()
        self._history: deque = deque(maxlen=int(history))
        self._transitions: deque = deque(maxlen=int(history))
        self._last_fire: Dict[str, float] = {}
        self._prev: Optional[FlightSample] = None
        self._seq = self._max_existing_seq()
        self._owns_tracer = False
        self._thread: Optional[threading.Thread] = None
        self._stop_flag = threading.Event()

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        """Poll on a daemon thread; installs a bounded tracer (the black
        box's span ring) if none is active."""
        assert self._thread is None, "flight recorder already running"
        if not _trace.get_tracer().enabled:
            _trace.enable(capacity=self.trace_capacity)
            self._owns_tracer = True
        self._stop_flag.clear()

        def loop() -> None:
            _trace.set_thread_name("flight")
            while not self._stop_flag.wait(self.poll_s):
                try:
                    self.observe()
                except Exception:
                    pass  # the recorder must never take the service down

        self._thread = threading.Thread(target=loop, name="hqi-flight", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._thread is not None:
            self._stop_flag.set()
            self._thread.join()
            self._thread = None
        if self._owns_tracer:
            _trace.disable()
            self._owns_tracer = False

    # ------------------------------------------------------------ observing

    def _sample(self) -> FlightSample:
        return FlightSample(
            t=time.perf_counter(),
            health=self.service.health().as_dict(),
            telemetry=self.service.telemetry.summary(),
        )

    def observe(self) -> Optional[str]:
        """One poll: sample, track health transitions, evaluate every rule.
        At most ONE incident bundle per call (listing every tripped rule);
        returns its path, or None."""
        cur = self._sample()
        with self._lock:
            prev = self._prev
            self._prev = cur
            self._history.append(cur)
            if prev is not None and prev.health.get("status") != cur.health.get("status"):
                self._transitions.append(
                    {
                        "t": cur.t,
                        "from": prev.health.get("status"),
                        "to": cur.health.get("status"),
                    }
                )
            if prev is None:
                return None  # first sample: nothing to edge-trigger against
            tripped: List[Tuple[str, str]] = []
            for rule in self.rules:
                last = self._last_fire.get(rule.name)
                if last is not None and cur.t - last < rule.cooldown_s:
                    continue
                try:
                    detail = rule.check(prev, cur)
                except Exception:
                    detail = None  # a broken rule must not break the poll
                if detail:
                    tripped.append((rule.name, detail))
                    self._last_fire[rule.name] = cur.t
            if not tripped:
                return None
            return self._dump_locked(tripped, cur)

    def force(self, reason: str = "manual") -> str:
        """Unconditional dump (operator-initiated postmortem)."""
        cur = self._sample()
        with self._lock:
            self._prev = cur
            self._history.append(cur)
            return self._dump_locked([("forced", reason)], cur)

    # -------------------------------------------------------------- dumping

    def _max_existing_seq(self) -> int:
        seq = 0
        try:
            for name in os.listdir(self.root):
                if name.startswith("incident-"):
                    try:
                        seq = max(seq, int(name.split("-")[1]))
                    except (IndexError, ValueError):
                        continue
        except OSError:
            pass
        return seq

    def _dump_locked(self, tripped: List[Tuple[str, str]], cur: FlightSample) -> str:
        self._seq += 1
        rule_names = [n for n, _ in tripped]
        dirname = f"incident-{self._seq:04d}-{rule_names[0].replace(':', '_')}"
        final = os.path.join(self.root, dirname)
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)

        tracer = _trace.get_tracer()
        try:
            tracer.export(os.path.join(tmp, "trace.json"))
        except Exception:
            with open(os.path.join(tmp, "trace.json"), "w") as f:
                json.dump({"traceEvents": []}, f)
        with open(os.path.join(tmp, "metrics.json"), "w") as f:
            f.write(get_registry().to_json(indent=2, detail=True))
        prof = get_profiler()
        with open(os.path.join(tmp, "profile.json"), "w") as f:
            json.dump(prof.report(), f, indent=2)

        current_gen = None
        if self.store_root is not None:
            try:
                from ..store.snapshot import current_generation

                current_gen = current_generation(self.store_root)
            except Exception:
                pass
        try:
            from ..fault import failpoints as _fp

            armed = sorted(_fp.list_armed())
        except Exception:
            armed = []
        try:
            recent = self.service.telemetry.recent_flushes()
        except Exception:
            recent = []
        manifest = {
            "schema": INCIDENT_SCHEMA,
            "seq": self._seq,
            "rules": rule_names,
            "detail": dict(tripped),
            "t_unix": time.time(),
            "t_perf": cur.t,
            "health": cur.health,
            "telemetry": cur.telemetry,
            "health_transitions": list(self._transitions),
            "recent_flushes": recent,
            "armed_failpoints": armed,
            "current_generation": current_gen,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2, default=str)

        os.rename(tmp, final)  # atomic publish: readers never see a partial
        self.incidents_written += 1
        self._prune_locked()
        return final

    def _prune_locked(self) -> None:
        dirs = sorted(
            n for n in os.listdir(self.root)
            if n.startswith("incident-") and not n.endswith(".tmp")
        )
        for name in dirs[: max(0, len(dirs) - self.max_incidents)]:
            shutil.rmtree(os.path.join(self.root, name), ignore_errors=True)

    def incidents(self) -> List[str]:
        """Retained incident directories, oldest first."""
        return sorted(
            os.path.join(self.root, n)
            for n in os.listdir(self.root)
            if n.startswith("incident-") and not n.endswith(".tmp")
        )


def validate_incident_bundle(path: str) -> Dict[str, Any]:
    """Schema-check one incident directory; returns its manifest.

    Shared by the tests, bench_perf's live-incident smoke, and CI: required
    files present, manifest fields complete, the trace Chrome-trace-valid,
    metrics/profile JSON-parseable. Raises ValueError on any violation.
    """
    for name in _BUNDLE_FILES:
        if not os.path.isfile(os.path.join(path, name)):
            raise ValueError(f"incident bundle {path!r} missing {name}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    missing = _MANIFEST_REQUIRED - set(manifest)
    if missing:
        raise ValueError(f"manifest missing fields {sorted(missing)}")
    if manifest["schema"] != INCIDENT_SCHEMA:
        raise ValueError(f"unknown incident schema {manifest['schema']!r}")
    if not manifest["rules"]:
        raise ValueError("incident tripped no rules")
    with open(os.path.join(path, "trace.json")) as f:
        _trace.validate_chrome_trace(json.load(f))
    with open(os.path.join(path, "metrics.json")) as f:
        json.load(f)
    with open(os.path.join(path, "profile.json")) as f:
        json.load(f)
    return manifest
