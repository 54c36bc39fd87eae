"""The port's kernel dispatch profiler (``repro_torch.obs.profile``): the
reference's tests (``tests/test_profile.py``) run against the port on the
CPU — attribution math recomputed from the plan, FLOPs against the engine's
own accounting, coverage 1.0, the disabled profiler allocation-free, the
process wiring (fence hold, ops issue hook, registry source, trace
instants), thread labels — plus the port against the reference: equal
per-dispatch rows for the same plan, and ``BENCH_perf_baseline.json``'s
exact rows reproduced from a ``to_state()``-loaded index.
"""
import json
import threading
import tracemalloc
from pathlib import Path

import numpy as np
import pytest

from repro.core import HQIConfig as RefHQIConfig
from repro.core import HQIIndex as RefHQIIndex
from repro.core.arena import PackedArena as RefPackedArena
from repro.core.ivf import IVFIndex as RefIVFIndex
from repro.core.plan import build_plan as ref_build_plan
from repro.core.planner import execute_plan as ref_execute_plan
from repro.obs import profile as ref_profile
from repro_torch.core import HQIConfig, HQIIndex
from repro_torch.core.arena import PackedArena
from repro_torch.core.ivf import IVFIndex
from repro_torch.core.plan import EngineTask, PlanConfig, build_plan, _next_pow2
from repro_torch.core.planner import execute_plan
from repro_torch.kernels import ops
from repro_torch.launch.roofline import _HW_PROFILES, current_hardware
from repro_torch.obs import trace
from repro_torch.obs.metrics import MetricsRegistry, get_registry, set_registry
from repro_torch.obs.profile import (
    KernelProfiler,
    NullProfiler,
    disable_profiler,
    enable_profiler,
    get_profiler,
)

from conftest import small_db, small_workload

ROOT = Path(__file__).resolve().parents[1]
EXACT = 10_000


@pytest.fixture(autouse=True)
def _clean_profile():
    """Every test starts and leaves with profiler + tracer + registry reset."""
    disable_profiler()
    trace.disable()
    set_registry(None)
    ops.reset_dispatch_stats()
    yield
    disable_profiler()
    trace.disable()
    set_registry(None)
    ops.reset_dispatch_stats()


def _tiny_plan(n=300, d=8, m=5, k=3, seed=0):
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    ivf = IVFIndex.build(vecs, metric="l2", n_centroids=4, kmeans_iters=5, seed=0, device="cpu")
    arena = PackedArena.from_ivf(ivf)
    q = rng.normal(size=(m, d)).astype(np.float32)
    task = EngineTask(part=0, qrows=np.arange(m, dtype=np.int64), nprobe=4,
                      packed_bitmap=None)
    cfg = PlanConfig(tq_unit=8, min_list_pad=8, max_bucket_shapes=4)
    plan = build_plan(arena, [task], q, m=m, k=k, cfg=cfg)
    return plan, arena, q, cfg, d, k


# ---------------------------------------------------------------------------
# attribution math
# ---------------------------------------------------------------------------


def test_f32_attribution_matches_hand_computed_plan_facts():
    """Scan-phase bytes/FLOPs/occupancy == formulas recomputed from the plan."""
    plan, arena, q, cfg, d, k = _tiny_plan()
    prof = enable_profiler()
    execute_plan(plan, arena, q, cfg=cfg)

    # independently recomputed from the plan's buckets: per bucket of padded
    # list length lp, W = next_pow2(#units) padded work units of tq query
    # rows each; operands are Q [W,tq,d] f32, V [W,lp,d] f32, valid [W,lp]
    # bool, output scores+ids [W,tq,min(k,lp)] (4+8 bytes)
    exp_bytes = exp_flops = exp_flops_pad = 0
    exp_rows = exp_rows_pad = 0
    exp_dispatches = 0
    tq = plan.tq
    for lp, units in plan.buckets.items():
        W = _next_pow2(len(units), 1)
        exp_dispatches += 1
        exp_bytes += W * tq * d * 4 + W * lp * d * 4 + W * lp
        exp_bytes += W * tq * min(k, lp) * 12
        real = sum(
            len(u.qrows) * int(arena.list_len[u.glist]) for u in units
        )
        exp_flops += 2 * d * real
        exp_flops_pad += 2 * d * W * tq * lp
        exp_rows += sum(int(arena.list_len[u.glist]) for u in units)
        exp_rows_pad += W * lp

    scan = prof.totals(phase="scan", mode="f32")
    assert scan["dispatches"] == exp_dispatches
    assert scan["bytes"] == exp_bytes
    assert scan["flops"] == exp_flops
    assert scan["flops_padded"] == exp_flops_pad
    assert scan["row_occupancy"] == pytest.approx(exp_rows / exp_rows_pad)
    assert 0.0 < scan["row_occupancy"] <= 1.0
    # roofline terms derive from the same totals
    assert scan["gbps"] == pytest.approx(exp_bytes / scan["device_s"] / 1e9)
    assert scan["device_s"] > 0.0


def test_f32_flops_agree_with_engine_dists_computed():
    """2·d·(query,row) pairs: the profiler's scan FLOPs must equal the plan
    accountant's ``dists_computed`` view of the same workload."""
    from repro_torch.core.predicates import make_filter
    from repro_torch.core.types import Workload

    db = small_db(n=900, seed=5)
    rng = np.random.default_rng(5)
    # single pure-vector template: no predicate bitmaps, so every tuple
    # scanned is a distance computed and the two accountants must agree
    wl = Workload(
        vectors=rng.normal(size=(24, db.d)).astype(np.float32),
        templates=[make_filter()],
        template_of=np.zeros(24, dtype=np.int32),
        k=5,
    )
    hqi = HQIIndex.build(db, wl, HQIConfig(min_partition_size=128, max_leaves=8), device="cpu")
    prof = enable_profiler()
    res = hqi.search(wl, nprobe=EXACT, batch_vec=True)
    scan = prof.totals(phase="scan", mode="f32")
    assert scan["flops"] == 2.0 * db.d * res.tuples_scanned
    assert prof.report()["coverage"] == 1.0


def test_pq_attribution_and_coverage():
    """PQ scan FLOPs are one-hot LUT contractions (2·M·256 per pair); the
    re-rank is exact f32 over kprime candidates; all dispatches attributed."""
    from repro_torch.core.predicates import make_filter
    from repro_torch.core.types import Workload

    db = small_db(n=900, seed=7)  # >= 256 rows: train_pq needs 256 centroids
    rng = np.random.default_rng(7)
    wl = Workload(  # pure-vector template: tuples scanned == dists computed
        vectors=rng.normal(size=(24, db.d)).astype(np.float32),
        templates=[make_filter()],
        template_of=np.zeros(24, dtype=np.int32),
        k=5,
    )
    hqi = HQIIndex.build(
        db, wl,
        HQIConfig(min_partition_size=128, max_leaves=8, scan_mode="pq", pq_m=8),
        device="cpu",
    )
    prof = enable_profiler()
    res = hqi.search(wl, nprobe=EXACT, batch_vec=True)
    scan = prof.totals(phase="scan")
    assert scan["flops"] == 2.0 * 8 * 256 * res.tuples_scanned
    rerank = prof.totals(phase="rerank")
    assert rerank["dispatches"] >= 1
    assert 0.0 < rerank["flops"] <= rerank["flops_padded"]
    rep = prof.report()
    assert rep["coverage"] == 1.0
    assert rep["attributed"] == sum(rep["issued"].values())


def test_totals_filter_and_report_keys():
    plan, arena, q, cfg, d, k = _tiny_plan()
    prof = enable_profiler()
    execute_plan(plan, arena, q, cfg=cfg)
    rep = prof.report()
    assert rep["enabled"] is True
    assert set(rep["hardware"]) == {"name", "peak_flops", "hbm_bw", "link_bw"}
    assert all("/" in key for key in rep["phases"])
    all_phases = prof.totals()
    per_phase = [prof.totals(phase=p) for p in ("scan", "merge")]
    assert all_phases["dispatches"] == sum(
        t.get("dispatches", 0) for t in per_phase
    )
    assert prof.totals(phase="nope") == {}
    # format_table renders without error and names every aggregation key
    table = prof.format_table()
    for key in rep["phases"]:
        assert key in table


# ---------------------------------------------------------------------------
# process wiring
# ---------------------------------------------------------------------------


def test_enable_disable_wires_process_state():
    assert isinstance(get_profiler(), NullProfiler)
    assert not get_profiler().enabled
    prof = enable_profiler()
    try:
        assert get_profiler() is prof and prof.enabled
        assert trace._FENCE_HOLD  # dispatches fence even with tracing off
        assert ops._PROFILE_HOOK is not None
        assert "profile" in get_registry().snapshot()
    finally:
        disable_profiler()
    assert isinstance(get_profiler(), NullProfiler)
    assert not trace._FENCE_HOLD
    assert ops._PROFILE_HOOK is None
    assert "profile" not in get_registry().snapshot()


def test_profile_instants_land_in_trace():
    """With tracing AND profiling on, every dispatch emits a profile.dispatch
    instant carrying the attribution args (what check_obs requires)."""
    plan, arena, q, cfg, d, k = _tiny_plan()
    t = trace.enable(capacity=4096)
    prof = enable_profiler()
    execute_plan(plan, arena, q, cfg=cfg)
    evs = [e for e in t.events() if e["name"] == "profile.dispatch"]
    assert len(evs) == prof.report()["attributed"]
    for e in evs:
        assert e["ph"] == "i"
        assert {"phase", "mode", "shape", "device_us"} <= set(e["args"])
    doc = t.to_chrome_trace()
    assert trace.validate_chrome_trace(doc) > 0


def test_registry_source_snapshot_shape():
    plan, arena, q, cfg, d, k = _tiny_plan()
    enable_profiler()
    execute_plan(plan, arena, q, cfg=cfg)
    snap = get_registry().snapshot()["profile"]
    assert snap["enabled"] is True
    assert snap["attributed"] == snap["issued"] > 0
    assert "scan" in snap and snap["scan"]["dispatches"] >= 1


def test_reset_clears_aggregates_and_coverage():
    plan, arena, q, cfg, d, k = _tiny_plan()
    prof = enable_profiler()
    execute_plan(plan, arena, q, cfg=cfg)
    assert prof.totals()
    prof.reset()
    assert prof.totals() == {}
    rep = prof.report()
    assert rep["attributed"] == 0 and sum(rep["issued"].values()) == 0
    assert rep["coverage"] == 1.0  # vacuous, not 0/0


# ---------------------------------------------------------------------------
# disabled cost
# ---------------------------------------------------------------------------


def test_disabled_profiler_is_allocation_free():
    """The NullProfiler hot path retains nothing: planner guards are a bool
    check, ``t0()`` is a shared constant, record calls are no-ops."""
    disable_profiler()
    p = get_profiler()
    assert isinstance(p, NullProfiler)
    assert p.t0() == 0 and p.t0() is p.t0()
    assert ops._PROFILE_HOOK is None  # issue hook fully disarmed
    tracemalloc.start()
    base = tracemalloc.take_snapshot()
    for _ in range(1000):
        if p.enabled:  # the exact guard every planner site runs
            p.record_dispatch("scan", "f32", 64, p.t0(), nbytes=1, flops=1,
                              flops_padded=1, units=1, units_padded=1,
                              rows=1, rows_padded=1)
        p.t0()
    after = tracemalloc.take_snapshot()
    tracemalloc.stop()
    retained = sum(s.size_diff for s in after.compare_to(base, "lineno"))
    assert p.totals() == {} and p.snapshot() == {"enabled": False}
    assert retained < 16_384  # nothing retained beyond tracemalloc noise


def test_disabled_run_attributes_nothing():
    db = small_db(n=600, seed=9)
    wl = small_workload(db, n_queries=8)
    hqi = HQIIndex.build(db, wl, HQIConfig(min_partition_size=128, max_leaves=8), device="cpu")
    base = ops.dispatch_stats().snapshot()
    hqi.search(wl, nprobe=8, batch_vec=True)
    assert ops.dispatch_stats().delta_since(base).knn_calls > 0  # work ran
    assert get_profiler().totals() == {}


# ---------------------------------------------------------------------------
# thread labels (satellite: background-thread trace context)
# ---------------------------------------------------------------------------


def test_thread_name_tags_root_spans_and_emits_metadata():
    t = trace.enable(capacity=256)
    done = threading.Event()

    def worker():
        trace.set_thread_name("bg-worker")
        with trace.get_tracer().span("root"):
            with trace.get_tracer().span("child"):
                pass
        done.set()

    th = threading.Thread(target=worker)
    th.start()
    th.join()
    assert done.is_set()
    evs = t.events()
    root = next(e for e in evs if e["name"] == "root")
    child = next(e for e in evs if e["name"] == "child")
    assert root["args"]["thread"] == "bg-worker"
    assert "thread" not in child.get("args", {})  # only roots carry the tag
    metas = [e for e in evs if e.get("ph") == "M"]
    assert any(
        m["name"] == "thread_name" and m["args"]["name"] == "bg-worker"
        and m["tid"] == root["tid"]
        for m in metas
    )
    # one metadata event per thread, not per span
    assert sum(1 for m in metas if m["args"].get("name") == "bg-worker") == 1
    trace.validate_chrome_trace(t.to_chrome_trace())


def test_service_loop_spans_tagged_in_chrome_export():
    db = small_db(n=600, seed=11)
    wl = small_workload(db, n_queries=8)
    hqi = HQIIndex.build(db, wl, HQIConfig(min_partition_size=128, max_leaves=8), device="cpu")
    from repro_torch.service import HQIService, ServiceConfig

    svc = HQIService(hqi, ServiceConfig(k=wl.k, nprobe=8, max_batch=4,
                                        deadline_s=0.0))
    t = trace.enable(capacity=8192)
    svc.start(poll_s=1e-3)
    try:
        handles = [
            svc.submit(wl.vectors[i], wl.templates[wl.template_of[i]])
            for i in range(8)
        ]
        for h in handles:
            assert h.wait(timeout=120)
    finally:
        svc.stop()
    evs = t.events()
    tagged = [
        e for e in evs if e.get("args", {}).get("thread") == "service"
    ]
    assert tagged, "scheduler-thread root spans must carry thread='service'"
    metas = [
        e for e in evs
        if e.get("ph") == "M" and e.get("args", {}).get("name") == "service"
    ]
    assert len(metas) == 1
    trace.validate_chrome_trace(t.to_chrome_trace())


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------

# the fields both packages compute from the plan's shapes (the rest are
# timings and the rates derived from them)
SHAPE_FIELDS = ("dispatches", "bytes", "flops", "flops_padded", "units", "units_padded", "rows",
                "rows_padded", "unit_occupancy", "row_occupancy", "flop_efficiency")


def _shape_rows(report):
    return {key: {f: row[f] for f in SHAPE_FIELDS} for key, row in report["phases"].items()}


@pytest.mark.parametrize("mode,layout", [("f32", "segmented"), ("f32", "dense"), ("pq", "segmented"),
                                         ("pq", "dense")])
def test_both_packages_record_equal_rows(mode, layout):
    """The same plan (a reference index loaded through ``to_state()``) gives
    the same per-dispatch rows in both packages: every (phase, mode,
    shape) key with equal bytes, FLOPs, units and rows, real and padded;
    coverage 1.0 in both."""
    from repro.core.plan import PlanConfig as RefPlanConfig

    db = small_db(n=900, seed=4)
    wl = small_workload(db, n_queries=24, seed=5)
    cfg = RefHQIConfig(min_partition_size=128, max_leaves=8, scan_mode="pq", pq_m=4,
                       plan=RefPlanConfig(merge_layout=layout))
    ref = RefHQIIndex.build(db, wl, cfg)
    port = HQIIndex.from_state(ref.to_state(), device="cpu")
    ref_prof = ref_profile.enable_profiler()
    try:
        ref.search(wl, nprobe=4, batch_vec=True, scan_mode=mode)
        want = ref_prof.report()
    finally:
        ref_profile.disable_profiler()
    prof = enable_profiler()
    port.search(wl, nprobe=4, batch_vec=True, scan_mode=mode)
    got = prof.report()
    assert _shape_rows(got) == _shape_rows(want)
    assert got["coverage"] == want["coverage"] == 1.0
    assert got["issued"] == want["issued"]


# benchmarks/bench_perf.py's fixed workload (lines 30-36, 112-118)
PERF_N, PERF_D, PERF_Q, PERF_NPROBE = 6000, 16, 256, 8


def _profiled_pass(hqi, wl, prof, mode):
    """bench_perf.py's pass: a warm-up search, then one profiled search (its
    rows are per pass, so one pass gives them)."""
    hqi.search(wl, nprobe=PERF_NPROBE, batch_vec=True, scan_mode=mode)
    prof.reset()
    hqi.search(wl, nprobe=PERF_NPROBE, batch_vec=True, scan_mode=mode)
    return prof.totals(phase="scan"), prof.totals()


def _incident_smoke(root):
    """bench_perf.py's incident smoke on the port: a live service with an
    armed ``service.flush`` failpoint gives exactly one valid bundle."""
    from repro_torch.core.workload import kg_style
    from repro_torch.fault import failpoints
    from repro_torch.obs.flight import FlightRecorder, validate_incident_bundle
    from repro_torch.service import HQIService, ServiceConfig

    kg = kg_style(n=1500, d=PERF_D, queries_per_split=32, seed=1)
    wl = kg.splits[0]
    hqi = HQIIndex.build(kg.db, wl, HQIConfig(min_partition_size=128, max_leaves=8), device="cpu")
    svc = HQIService(hqi, ServiceConfig(k=wl.k, nprobe=PERF_NPROBE, max_batch=16))
    trace.enable(capacity=8192)
    rec = FlightRecorder(svc, str(root), max_incidents=4)
    try:
        assert rec.observe() is None  # baseline sample
        for i in range(8):
            svc.submit(wl.vectors[i], wl.templates[wl.template_of[i]])
        failpoints.arm("service.flush", count=1)
        svc.flush()  # the crash is contained; telemetry records the failure
        path = rec.observe()
        assert path is not None, "armed flush crash produced no incident"
        validate_incident_bundle(path)
        assert rec.observe() is None, "single crash dumped twice"
        return len(rec.incidents())
    finally:
        svc.stop(drain=False)
        trace.disable()
        failpoints.disarm_all()


def test_perf_baseline_rows(tmp_path):
    """``benchmarks/baselines/BENCH_perf_baseline.json``'s exact rows, from
    the port on the CPU: the fixed workload built by ``repro`` and loaded
    into the port with ``to_state()``, profiled in f32 and in PQ; coverage
    1.0; and one incident bundle from the flight-recorder smoke."""
    from repro.core.workload import kg_style as ref_kg_style

    base = json.loads((ROOT / "benchmarks/baselines/BENCH_perf_baseline.json").read_text())
    want = {name: row["value"] for name, row in base["backends"]["jnp"]["rows"].items()
            if row["kind"] == "exact"}
    kg = ref_kg_style(n=PERF_N, d=PERF_D, queries_per_split=PERF_Q, seed=0)
    wl = kg.splits[0]
    ref = RefHQIIndex.build(kg.db, wl, RefHQIConfig(min_partition_size=256, max_leaves=32,
                                                    scan_mode="pq", pq_m=8))
    hqi = HQIIndex.from_state(ref.to_state(), device="cpu")
    got = {}
    prof = enable_profiler()
    for mode in ("f32", "pq"):
        scan, total = _profiled_pass(hqi, wl, prof, mode)
        got[f"perf/{mode}_scan_bytes"] = scan["bytes"]
        got[f"perf/{mode}_scan_flops"] = scan["flops"]
        got[f"perf/{mode}_scan_occupancy"] = float(f"{scan['row_occupancy']:.12g}")
        got[f"perf/{mode}_scan_dispatches"] = total["dispatches"]
        got["perf/coverage"] = prof.report()["coverage"]
    got["perf/pq_rerank_flops"] = prof.totals(phase="rerank")["flops"]
    disable_profiler()
    got["perf/flight_incident"] = float(_incident_smoke(tmp_path / "incidents"))
    assert got == want
    assert want["perf/f32_scan_bytes"] == 14_718_592 and want["perf/pq_rerank_flops"] == 130_560


def test_h100_terms():
    """The h100 profile holds NVIDIA's published H100 SXM5 figures (fp32
    CUDA-core peak, HBM3, an NVLink 4 link); ``REPRO_HW`` picks any profile,
    and without a card the process maps to the cpu profile."""
    h = _HW_PROFILES["h100"]
    assert (h.peak_flops, h.hbm_bw, h.link_bw) == (67e12, 3.35e12, 50e9)
    assert set(_HW_PROFILES) == {"tpu-v5e", "cpu", "h100"}
    import os
    import torch

    old = os.environ.pop("REPRO_HW", None)
    try:
        if not torch.cuda.is_available():
            assert current_hardware().name == "cpu"
        os.environ["REPRO_HW"] = "h100"
        assert current_hardware() is h
        assert KernelProfiler().hardware is h
        os.environ["REPRO_HW"] = "nope"
        with pytest.raises(ValueError, match="REPRO_HW"):
            current_hardware()
    finally:
        os.environ.pop("REPRO_HW", None)
        if old is not None:
            os.environ["REPRO_HW"] = old
