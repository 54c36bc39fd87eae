"""The port's flight recorder (``repro_torch.obs.flight``): the reference's
tests (``tests/test_flight.py``) against the port on the CPU — trigger
matrix, bundle schema, ring bound, SLOs — plus bundles that each package's
validator accepts from the other. The live-service test follows the
poller by events, not sleeps.
"""
import json
import os
import threading
import time

import numpy as np
import pytest

from repro_torch.core import HQIConfig, HQIIndex
from repro_torch.fault import failpoints
from repro_torch.obs import trace
from repro_torch.obs.flight import (
    INCIDENT_SCHEMA,
    FlightRecorder,
    TriggerRule,
    default_rules,
    slo_rule,
    validate_incident_bundle,
)
from repro_torch.obs.metrics import (
    Histogram,
    MetricsRegistry,
    Objective,
    get_registry,
    set_registry,
)
from repro_torch.service import HQIService, ServiceConfig

from conftest import small_db, small_workload

EXACT = 10_000


@pytest.fixture(autouse=True)
def _clean():
    failpoints.disarm_all()
    trace.disable()
    set_registry(None)
    yield
    failpoints.disarm_all()
    trace.disable()
    set_registry(None)


@pytest.fixture(scope="module")
def db():
    return small_db(n=800, seed=21)


@pytest.fixture(scope="module")
def workload(db):
    return small_workload(db, n_queries=16)


def _service(db, wl, **kw):
    hqi = HQIIndex.build(db, wl, HQIConfig(min_partition_size=128, max_leaves=8), device="cpu")
    cfg = dict(k=wl.k, nprobe=EXACT, max_batch=16, deadline_s=0.0)
    cfg.update(kw)
    return HQIService(hqi, ServiceConfig(**cfg))


def _recorder(svc, tmp_path, **kw):
    trace.enable(capacity=4096)
    return FlightRecorder(svc, str(tmp_path / "incidents"), **kw)


# ---------------------------------------------------------------------------
# trigger matrix (manual observe: deterministic, no polling thread)
# ---------------------------------------------------------------------------


def test_flush_crash_fires_exactly_once(db, workload, tmp_path):
    svc = _service(db, workload)
    rec = _recorder(svc, tmp_path)
    try:
        assert rec.observe() is None  # first sample: nothing to diff
        for i in range(4):
            svc.submit(workload.vectors[i],
                       workload.templates[workload.template_of[i]])
        svc.flush()  # one clean flush: the record the bundle must carry
        for i in range(4):
            svc.submit(workload.vectors[i],
                       workload.templates[workload.template_of[i]])
        failpoints.arm("service.flush", count=1)
        svc.flush()  # crash contained by the service
        path = rec.observe()
        assert path is not None
        man = validate_incident_bundle(path)
        assert man["schema"] == INCIDENT_SCHEMA
        assert man["rules"] == ["flush_crash"]
        assert "flush_failures" in man["detail"]["flush_crash"]
        assert man["health"]["flush_failures"] == 1
        assert man["recent_flushes"], "bundle must carry the flush records"
        # same crash must not dump twice
        assert rec.observe() is None
        assert rec.incidents_written == 1
    finally:
        svc.stop(drain=False)


def test_swap_deadline_and_health_triggers(db, workload, tmp_path):
    svc = _service(db, workload)
    rec = _recorder(svc, tmp_path)
    try:
        rec.observe()
        svc.telemetry.record_swap()
        p1 = rec.observe()
        assert p1 is not None and validate_incident_bundle(p1)["rules"] == [
            "index_swap"
        ]

        svc.telemetry.record_deadline_expired(3)
        assert rec.observe() is None  # below the spike threshold (8)
        svc.telemetry.record_deadline_expired(10)
        p2 = rec.observe()
        assert p2 is not None and validate_incident_bundle(p2)["rules"] == [
            "deadline_spike"
        ]

        svc._degraded = True  # health status ok -> degraded edge
        p3 = rec.observe()
        man = validate_incident_bundle(p3)
        assert man["rules"] == ["health"]
        assert man["health"]["status"] == "degraded"
        assert man["health_transitions"][-1]["to"] == "degraded"
        assert rec.observe() is None  # still degraded: edge already fired
        svc._degraded = False
        assert rec.observe() is None  # recovery is not an incident
    finally:
        svc.stop(drain=False)


def test_multiple_triggers_one_observe_one_bundle(db, workload, tmp_path):
    """Simultaneous trips produce ONE bundle listing every rule."""
    svc = _service(db, workload)
    rec = _recorder(svc, tmp_path)
    try:
        rec.observe()
        svc.telemetry.record_swap()
        svc.telemetry.record_deadline_expired(10)
        path = rec.observe()
        man = validate_incident_bundle(path)
        assert set(man["rules"]) == {"index_swap", "deadline_spike"}
        assert rec.incidents_written == 1
    finally:
        svc.stop(drain=False)


def test_slo_objective_fires_on_breach_edge_only(db, workload, tmp_path):
    svc = _service(db, workload)
    obj = Objective("p99-latency", "svc.lat_ms", stat="p99", max_value=5.0,
                    min_count=4)
    rec = _recorder(svc, tmp_path, objectives=(obj,))
    try:
        h = get_registry().histogram("svc.lat_ms")
        rec.observe()
        for _ in range(8):
            h.observe(1.0)
        assert rec.observe() is None  # within objective
        for _ in range(8):
            h.observe(500.0)  # p99 blows through max_value
        path = rec.observe()
        man = validate_incident_bundle(path)
        assert man["rules"] == ["slo:p99-latency"]
        assert "> max 5" in man["detail"]["slo:p99-latency"]
        # continuous breach: histograms are cumulative, the edge fired once
        assert rec.observe() is None
        assert rec.observe() is None
        # bundle's metrics.json carries the offending distribution (detail)
        with open(os.path.join(path, "metrics.json")) as f:
            metrics = json.load(f)
        assert "buckets" in metrics["svc.lat_ms"]
    finally:
        svc.stop(drain=False)


def test_rule_cooldown_suppresses_refiring(db, workload, tmp_path):
    svc = _service(db, workload)
    rec = _recorder(svc, tmp_path)
    try:
        rec.observe()
        svc.telemetry.record_swap()
        assert rec.observe() is not None
        svc.telemetry.record_swap()  # second swap inside the 5 s cooldown
        assert rec.observe() is None
    finally:
        svc.stop(drain=False)


def test_broken_rule_cannot_break_the_poll(db, workload, tmp_path):
    def boom(prev, cur):
        raise RuntimeError("bad rule")

    svc = _service(db, workload)
    rec = _recorder(svc, tmp_path,
                    rules=default_rules() + [TriggerRule("boom", boom)])
    try:
        rec.observe()
        svc.telemetry.record_swap()
        path = rec.observe()  # boom must not mask the real trigger
        assert validate_incident_bundle(path)["rules"] == ["index_swap"]
    finally:
        svc.stop(drain=False)


# ---------------------------------------------------------------------------
# bundles: ring bound, sequencing, schema validation
# ---------------------------------------------------------------------------


def test_incident_ring_bounded_and_seq_monotonic(db, workload, tmp_path):
    svc = _service(db, workload)
    rec = _recorder(svc, tmp_path, max_incidents=3)
    try:
        paths = [rec.force(f"n{i}") for i in range(7)]
        assert len(set(paths)) == 7
        kept = rec.incidents()
        assert len(kept) == 3  # oldest pruned
        seqs = [validate_incident_bundle(p)["seq"] for p in kept]
        assert seqs == sorted(seqs) == [5, 6, 7]
        assert not any(p.endswith(".tmp") for p in os.listdir(rec.root))
    finally:
        svc.stop(drain=False)


def test_seq_resumes_past_existing_incidents(db, workload, tmp_path):
    svc = _service(db, workload)
    rec = _recorder(svc, tmp_path)
    try:
        rec.force()
        rec2 = FlightRecorder(svc, rec.root)  # fresh recorder, same ring
        p = rec2.force()
        assert validate_incident_bundle(p)["seq"] == 2
    finally:
        svc.stop(drain=False)


def test_validate_rejects_tampered_bundles(db, workload, tmp_path):
    svc = _service(db, workload)
    rec = _recorder(svc, tmp_path)
    try:
        path = rec.force("tamper-target")
        validate_incident_bundle(path)

        os.remove(os.path.join(path, "profile.json"))
        with pytest.raises(ValueError, match="missing profile.json"):
            validate_incident_bundle(path)
        with open(os.path.join(path, "profile.json"), "w") as f:
            f.write("{}")

        man_path = os.path.join(path, "manifest.json")
        with open(man_path) as f:
            man = json.load(f)
        man.pop("armed_failpoints")
        with open(man_path, "w") as f:
            json.dump(man, f)
        with pytest.raises(ValueError, match="armed_failpoints"):
            validate_incident_bundle(path)

        man["armed_failpoints"] = []
        man["schema"] = "who-knows-v9"
        with open(man_path, "w") as f:
            json.dump(man, f)
        with pytest.raises(ValueError, match="schema"):
            validate_incident_bundle(path)
    finally:
        svc.stop(drain=False)


def test_bundle_records_armed_failpoints_and_generation(db, workload, tmp_path):
    store_root = tmp_path / "store"
    store_root.mkdir()
    svc = _service(db, workload)
    rec = _recorder(svc, tmp_path, store_root=str(store_root))
    try:
        failpoints.arm("compact.cycle", prob=1.0)
        man = validate_incident_bundle(rec.force())
        assert "compact.cycle" in man["armed_failpoints"]
        assert man["current_generation"] is None  # no snapshot written yet
    finally:
        svc.stop(drain=False)


# ---------------------------------------------------------------------------
# acceptance: live service + background recorder + injected flush crash
# ---------------------------------------------------------------------------


def test_live_service_crash_produces_one_bundle_with_trace(db, workload, tmp_path):
    svc = _service(db, workload, deadline_s=0.0)
    root = str(tmp_path / "incidents")
    rec = FlightRecorder(svc, root, poll_s=0.005)
    # the poller's progress, by events (no sleeps): each observe() sets
    # `polled`, one that dumped sets `dumped`
    polled, dumped = threading.Event(), threading.Event()
    observe = rec.observe

    def observe_and_signal():
        path = observe()
        if path is not None:
            dumped.set()
        polled.set()
        return path

    def polls(n):
        for _ in range(n):
            polled.clear()
            assert polled.wait(timeout=60)

    rec.observe = observe_and_signal
    assert isinstance(trace.get_tracer(), trace.NullTracer)
    rec.start()  # installs its own bounded tracer (black box)
    svc.start(poll_s=1e-3)
    try:
        assert trace.get_tracer().enabled
        # healthy traffic first, so the trace window holds real serving spans
        hs = [
            svc.submit(workload.vectors[i],
                       workload.templates[workload.template_of[i]])
            for i in range(8)
        ]
        for h in hs:
            assert h.wait(timeout=120)
        polls(2)  # clean polls establish the baseline sample
        failpoints.arm("service.flush", count=1)
        for i in range(8):
            svc.submit(workload.vectors[i],
                       workload.templates[workload.template_of[i]])
        assert dumped.wait(timeout=60), "armed flush crash produced no incident"
        svc.drain()
        polls(3)  # polls after the crash must not dump it again
    finally:
        svc.stop(drain=False)
        rec.stop()
    assert isinstance(trace.get_tracer(), trace.NullTracer)  # tracer returned
    bundles = rec.incidents()
    assert len(bundles) == 1, f"expected exactly one incident, got {bundles}"
    man = validate_incident_bundle(bundles[0])
    assert "flush_crash" in man["rules"]
    with open(os.path.join(bundles[0], "trace.json")) as f:
        doc = json.load(f)
    names = {e["name"] for e in doc["traceEvents"]}
    assert "flush" in names, "bundle trace must contain the offending window"
    threads = {
        e["args"]["thread"]
        for e in doc["traceEvents"]
        if e.get("args", {}).get("thread")
    }
    assert "service" in threads  # scheduler-thread spans labeled for triage


# ---------------------------------------------------------------------------
# satellites riding along: Histogram.to_json buckets, Objective.evaluate
# ---------------------------------------------------------------------------


def test_histogram_to_json_buckets_reconstruct_count():
    h = Histogram()
    vals = [0.0012, 0.5, 0.9, 1.7, 1.7, 42.0, 1e9]
    for v in vals:
        h.observe(v)
    doc = h.to_json()
    for key in ("count", "sum", "mean", "min", "max", "p50", "p99"):
        assert key in doc  # summary fields kept
    b = doc["buckets"]
    assert sum(b["counts"]) == doc["count"] == len(vals)
    assert len(b["le"]) == len(b["counts"])
    assert all(c >= 0 for c in b["counts"])
    # boundaries are the histogram's own ladder, increasing (overflow = None)
    finite = [x for x in b["le"] if x is not None]
    assert finite == sorted(finite)
    empty = Histogram().to_json()
    assert empty["buckets"] == {"first": 0, "le": [], "counts": []}


def test_registry_snapshot_detail_includes_buckets():
    reg = MetricsRegistry()
    reg.histogram("x").observe(3.0)
    assert "buckets" not in reg.snapshot()["x"]
    assert "buckets" in reg.snapshot(detail=True)["x"]
    assert "buckets" in json.loads(reg.to_json(detail=True))["x"]


def test_objective_evaluate_modes():
    reg = MetricsRegistry()
    assert Objective("o", "missing", max_value=1.0).evaluate(reg) is None
    g = reg.gauge("g")
    g.set(2.0)
    assert "> max" in Objective("o", "g", stat="value", max_value=1.0).evaluate(reg)
    assert Objective("o", "g", stat="value", max_value=3.0).evaluate(reg) is None
    assert "< min" in Objective("o", "g", stat="value", min_value=5.0).evaluate(reg)
    h = reg.histogram("h")
    h.observe(10.0)
    ob = Objective("o", "h", stat="p99", max_value=1.0, min_count=3)
    assert ob.evaluate(reg) is None  # below min_count: no breach yet
    h.observe(10.0)
    h.observe(10.0)
    assert "> max" in ob.evaluate(reg)


def test_slo_rule_rearms_after_recovery():
    reg = MetricsRegistry()
    set_registry(reg)
    g = reg.gauge("recall")
    g.set(0.95)
    rule = slo_rule(Objective("recall-floor", "recall", stat="value",
                              min_value=0.9), cooldown_s=0.0)
    ok = type("S", (), {"health": {}, "telemetry": {}, "t": 0.0})()
    assert rule.check(ok, ok) is None
    g.set(0.5)
    assert rule.check(ok, ok) is not None  # breach edge
    assert rule.check(ok, ok) is None  # still breached: no refire
    g.set(0.95)
    assert rule.check(ok, ok) is None  # recovered
    g.set(0.5)
    assert rule.check(ok, ok) is not None  # re-armed after recovery


def test_bundles_validate_across_packages(db, workload, tmp_path):
    """A port bundle passes the reference's validator and a reference bundle
    the port's: the schema is the reference's, key for key."""
    from repro.core import HQIConfig as RefHQIConfig
    from repro.core import HQIIndex as RefHQIIndex
    from repro.obs import flight as ref_flight
    from repro.obs import trace as ref_trace
    from repro.service import HQIService as RefHQIService
    from repro.service import ServiceConfig as RefServiceConfig

    svc = _service(db, workload)
    rec = _recorder(svc, tmp_path)
    try:
        ours = rec.force("port")
    finally:
        svc.stop(drain=False)
    ref_hqi = RefHQIIndex.build(db, workload, RefHQIConfig(min_partition_size=128, max_leaves=8))
    ref_svc = RefHQIService(ref_hqi, RefServiceConfig(k=workload.k, nprobe=EXACT, max_batch=16))
    ref_trace.enable(capacity=256)
    try:
        theirs = ref_flight.FlightRecorder(ref_svc, str(tmp_path / "ref")).force("reference")
    finally:
        ref_svc.stop(drain=False)
        ref_trace.disable()
    a, b = ref_flight.validate_incident_bundle(ours), validate_incident_bundle(theirs)
    assert set(a) == set(b) and a["schema"] == b["schema"] == INCIDENT_SCHEMA
