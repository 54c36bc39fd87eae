"""The port's online service against the reference, on the CPU.

A port service (``repro_torch.service``) and a reference service
(``repro.service``) are built over the same index (the reference's
``to_state()`` loaded into the port with ``device="cpu"``), fed the same
submit / insert / delete / ``refresh()`` script, and must answer identically
at every stage — both equal to the exact answer over the live snapshot, on
the f32 delta path and on the PQ delta path. The rest holds the port's
service machinery (delta scans and the operands they pass, scheduler,
admission, telemetry, deadlines, crash containment, overload shedding, drift,
swaps, the background thread) to the reference's contracts.
"""
import threading

import numpy as np
import pytest

from repro.core import HQIConfig as RefConfig
from repro.core import HQIIndex as RefIndex
from repro.core import train_pq as ref_train_pq
from repro.core.pq import adc_tables as ref_adc_tables
from repro.service import DeltaStore as RefDelta
from repro.service import HQIService as RefService
from repro.service import ServiceConfig as RefServiceConfig
from repro_torch.core.baselines import exhaustive_search
from repro_torch.core.hqi import HQIIndex
from repro_torch.core.pq import PQCodebook
from repro_torch.core.types import Workload
from repro_torch.fault import failpoints
from repro_torch.kernels import ops
from repro_torch.service import (
    STORE_NOT_PORTED,
    DeadlineExceeded,
    DeltaStore,
    HQIService,
    MicroBatchScheduler,
    PendingQuery,
    QueryError,
    QueueFull,
    ResultPending,
    ServiceConfig,
)

from conftest import assert_same_results, small_db, small_workload

EXACT = 10_000  # nprobe past every list count: search becomes exact
CFG = dict(min_partition_size=128, max_leaves=16)


@pytest.fixture(scope="module")
def db():
    return small_db(n=1500, seed=5)


@pytest.fixture(scope="module")
def workload(db):
    return small_workload(db, n_queries=48)


@pytest.fixture(scope="module")
def state(db, workload):
    return RefIndex.build(db, workload, RefConfig(**CFG)).to_state()


@pytest.fixture(autouse=True)
def _disarm():
    yield
    failpoints.disarm_all()


def _port(state, **cfg_kw):
    kw = dict(k=5, nprobe=EXACT, max_batch=16, deadline_s=0.0)
    kw.update(cfg_kw)
    return HQIService(HQIIndex.from_state(state, device="cpu"), ServiceConfig(**kw))


def _stream(svc, wl):
    """Submit the whole workload, drain; stacked (ids, scores)."""
    handles = [svc.submit(wl.vectors[i], wl.templates[wl.template_of[i]]) for i in range(wl.m)]
    assert svc.drain() == wl.m
    assert all(h.ok for h in handles)
    return np.stack([h.ids for h in handles]), np.stack([h.scores for h in handles])


def _exact(svc, wl):
    """The exact answer over the live snapshot, in global ids."""
    snap, live = svc.snapshot_db(), svc.live_ids()
    res = exhaustive_search(snap, wl, device="cpu")
    return np.where(res.ids >= 0, live[np.maximum(res.ids, 0)], -1), res.scores


def _write_cycle(svc, db, seed, n_new=120, n_del=60):
    rng = np.random.default_rng(seed)
    newv = db.vectors[rng.integers(0, db.n, n_new)] + 0.01 * rng.normal(
        size=(n_new, db.d)).astype(np.float32)
    cols = {
        "A": rng.random(n_new).astype(np.float32),
        "B": rng.random(n_new).astype(np.float32),
        "cat": rng.integers(0, 8, n_new).astype(np.int32),
        "tags": rng.random((n_new, 6)) < 0.5,
    }
    ids = svc.insert(newv, cols)
    svc.delete(rng.integers(0, db.n, n_del))
    svc.delete(ids[:10])
    return ids, newv, cols


@pytest.mark.parametrize("delta", ["f32", "pq"])
def test_service_parity_across_writes_and_refresh(db, workload, delta):
    """The port and the reference answer identically through an interleaved
    insert/delete cycle, a refresh() fold and a second cycle with partial
    columns, and both equal the exact answer; on the "pq" delta path the
    buffer scans compressed (threshold 8, the refine wide enough to be
    exact)."""
    index = RefIndex.build(db, workload, RefConfig(**CFG, refine_factor=26))
    if delta == "pq":
        index.attach_pq(ref_train_pq(db.vectors, 4, metric=db.metric))
    state = index.to_state()
    kw = dict(k=workload.k, nprobe=EXACT, max_batch=16, deadline_s=0.0,
              delta_pq_threshold=8 if delta == "pq" else 4096)
    ref = RefService(RefIndex.from_state(state), RefServiceConfig(**kw))
    port = HQIService(HQIIndex.from_state(state, device="cpu"), ServiceConfig(**kw))
    n_parts = len(port.index.partitions)

    def check(compressed: bool) -> None:
        ops.reset_dispatch_stats()
        a = _stream(ref, workload)
        b = _stream(port, workload)
        shapes = ops.dispatch_stats().snapshot().shapes
        assert any(s[0] == "pq" for s in shapes) == compressed, shapes
        assert_same_results(a[1], a[0], b[1], b[0])
        want = _exact(port, workload)
        assert_same_results(b[1], b[0], want[1], want[0])
        np.testing.assert_array_equal(ref.live_ids(), port.live_ids())

    check(False)
    ids = None
    for svc in (ref, port):
        got, newv, cols = _write_cycle(svc, db, 7)
        assert ids is None or np.array_equal(got, ids)
        ids = got
    assert ids[0] == db.n
    check(delta == "pq")
    assert ref.refresh() == port.refresh() == 120
    assert len(port.index.partitions) == n_parts  # extended, not rebuilt
    check(False)
    for svc in (ref, port):
        svc.insert(newv[:30], columns={"A": cols["A"][:30]})
        svc.delete([db.n + 120, db.n + 121])
    check(delta == "pq")


def _stores(db, pq):
    ref = RefDelta(db, first_id=db.n, pq=pq)
    port = DeltaStore(db, first_id=db.n, device="cpu",
                      pq=None if pq is None else PQCodebook.from_state(pq.to_state()))
    rng = np.random.default_rng(3)
    for n in (150, 90):  # two inserts: rows append on the device
        vecs = db.vectors[rng.integers(0, db.n, n)] + 0.01 * rng.normal(
            size=(n, db.d)).astype(np.float32)
        cols = {"A": rng.random(n).astype(np.float32), "B": rng.random(n).astype(np.float32),
                "cat": rng.integers(0, 8, n).astype(np.int32), "tags": rng.random((n, 6)) < 0.5}
        np.testing.assert_array_equal(ref.insert(vecs, cols), port.insert(vecs, cols))
    for gid in rng.integers(db.n, db.n + 240, 50):
        assert ref.delete(int(gid)) == port.delete(int(gid))
    return ref, port


@pytest.mark.parametrize("path", ["f32", "pq"])
def test_delta_scan_matches_reference(db, workload, monkeypatch, path):
    """``DeltaView.scan`` equals the reference's on the same rows; the scan
    passes ``n_live`` = each unit's query count (and 1 / 0 on the re-rank's
    real / padding units), with the reference's operands on live slots."""
    pq = ref_train_pq(db.vectors, 4, metric=db.metric) if path == "pq" else None
    ref, port = _stores(db, pq)
    calls = []
    for name in ("workunit_topk", "workunit_pq_topk"):
        real = getattr(ops, name)

        def spy(*args, _name=name, _real=real, **kw):
            calls.append((_name, args, kw))
            return _real(*args, **kw)

        monkeypatch.setattr(ops, name, spy)
    threshold = 16 if path == "pq" else None
    a = ref.scan(workload, pq_threshold=threshold, refine_factor=4)
    b = [t.numpy() for t in port.scan(workload, pq_threshold=threshold, refine_factor=4)]
    assert_same_results(a[0], a[1], b[0], b[1])
    sizes = [len(workload.queries_for_template(t)) for t in range(len(workload.templates))]
    sizes = [s for s in sizes if s]
    if path == "f32":
        assert [c[0] for c in calls] == ["workunit_topk"]
        q = calls[0][1][0]
        assert calls[0][2]["n_live"].tolist() == sizes
        assert q.shape[1] == 1 << (max(sizes) - 1).bit_length()
        return
    assert [c[0] for c in calls] == ["workunit_pq_topk", "workunit_topk"]
    (_, (luts, codes, valid, kprime), kw), (_, (qr, vr, valid_r, kk), kw_r) = calls
    assert kw["n_live"].tolist() == sizes and kprime == 4 * workload.k
    want = ref_adc_tables(pq, workload.vectors)
    for w, ti in enumerate(t for t in range(len(workload.templates))
                           if len(workload.queries_for_template(t))):
        qidx = workload.queries_for_template(ti)
        np.testing.assert_array_equal(luts[w, : len(qidx)].numpy(), want[qidx])
        np.testing.assert_array_equal(codes[w, : port.n].numpy(), ref._codes)
    mp = qr.shape[0]
    assert kw_r["n_live"].tolist() == [1] * workload.m + [0] * (mp - workload.m)


def test_delta_store_scan_edges(db):
    delta = DeltaStore(db, first_id=db.n, device="cpu")
    wl = Workload(vectors=np.zeros((3, db.d), dtype=np.float32), templates=[()],
                  template_of=np.zeros(3, dtype=np.int32), k=4)
    assert delta.scan(wl) is None  # empty buffer
    ids = delta.insert(np.ones((2, db.d), dtype=np.float32))
    assert list(ids) == [db.n, db.n + 1]
    for i in ids:
        assert delta.delete(int(i))
    assert not delta.delete(int(ids[0]))  # already dead
    assert not delta.delete(0)  # not a buffer row
    assert delta.scan(wl) is None  # all tombstoned
    ids2 = delta.insert(np.full((1, db.d), 2.0, dtype=np.float32))
    s, i = (t.numpy() for t in delta.scan(wl))  # k=4 > 1 live row: padded with (-inf, -1)
    assert (i[:, 0] == ids2[0]).all() and (i[:, 1:] == -1).all()
    assert np.isneginf(s[:, 1:]).all()


def test_scheduler_triggers_and_slot_padding():
    sched = MicroBatchScheduler(max_batch=4, deadline_s=0.5, pad_pow2=True)
    vec = np.zeros(8, dtype=np.float32)
    t0 = 100.0
    for _ in range(3):
        sched.push(PendingQuery(handle=None, vector=vec, filt=(), t_submit=t0))
    assert not sched.ready(now=t0 + 0.1)  # under size, under deadline
    assert sched.ready(now=t0 + 0.6)  # deadline fired
    sched.push(PendingQuery(handle=None, vector=vec, filt=(), t_submit=t0))
    assert sched.ready(now=t0 + 0.1)  # size fired
    batch = sched.take()
    assert len(batch) == 4 and len(sched) == 0
    wl, n_real = sched.build_workload(batch[:3], k=5)
    assert n_real == 3 and wl.m == 4  # padded to the next power-of-two slot
    assert wl.template_of[3] == wl.template_of[0]


def test_queue_bound_and_telemetry(state, workload):
    svc = _port(state, queue_bound=4)
    for i in range(4):
        svc.submit(workload.vectors[i], workload.templates[0])
    with pytest.raises(QueueFull):
        svc.submit(workload.vectors[4], workload.templates[0])
    assert svc.telemetry.summary()["rejected"] == 1
    assert svc.drain() == 4
    svc = _port(state, nprobe=8)
    _stream(svc, workload)
    s = svc.telemetry.summary()
    assert s["queries"] == workload.m and s["flushes"] == -(-workload.m // 16)
    assert s["p50_latency_s"] > 0 and s["p99_latency_s"] >= s["p50_latency_s"]
    assert s["merge_dispatches_per_flush"] >= 1
    assert svc.health().as_dict()["status"] == "ok"


def test_deadlines_and_result_semantics(state, workload):
    svc = _port(state)
    with pytest.raises(DeadlineExceeded):  # lapsed at admission: never queued
        svc.submit(workload.vectors[0], deadline_s=0.0)
    assert len(svc.scheduler) == 0
    h = svc.submit(workload.vectors[0], deadline_s=1e-9)
    h_ok = svc.submit(workload.vectors[1], deadline_s=60.0)
    with pytest.raises(ResultPending):
        h_ok.result()
    svc.drain()
    assert isinstance(h.error, DeadlineExceeded)
    with pytest.raises(DeadlineExceeded):
        h.result()
    ids, scores = h_ok.result(timeout=5.0)
    assert ids.shape == (5,) and scores.shape == (5,)
    assert svc.telemetry.summary()["deadline_expired"] >= 2


def test_flush_failpoint_is_contained_per_flush(state, workload):
    svc = _port(state)
    with failpoints.armed("service.flush", "runtimeerror", count=1):
        assert "service.flush" in svc.health().armed_failpoints
        handles = [svc.submit(workload.vectors[i]) for i in range(20)]
        svc.drain()
    failed = [h for h in handles if not h.ok]
    assert len(failed) == 16  # the first flush of 16 failed, the next answered
    for h in failed:
        assert isinstance(h.error, QueryError) and isinstance(h.error.cause, RuntimeError)
    assert all(h.ok for h in handles[16:])
    assert svc.telemetry.summary()["flush_failures"] == 1
    got = _stream(svc, workload)
    want = _exact(svc, workload)
    assert_same_results(got[1], got[0], want[1], want[0])


def test_overload_sheds_to_pq_and_recovers(db, workload):
    """Queue pressure sheds flushes to the PQ scan of the main index (the
    engine's resident-LUT dispatch: every group joins the plan);
    hysteresis recovers once the queue drains; the next answers are exact."""
    index = RefIndex.build(db, workload, RefConfig(**CFG))
    index.attach_pq(ref_train_pq(db.vectors, 4, metric=db.metric))
    svc = _port(index.to_state(), max_batch=8, overload_queue_depth=16,
                degraded_refine_factor=4, batch_vec=True)
    handles = [svc.submit(workload.vectors[i % workload.m]) for i in range(64)]
    ops.reset_dispatch_stats()
    assert svc.flush() == 8  # post-take depth 56 >> 16: enters degraded
    assert any(s[0] == "pq-res" for s in ops.dispatch_stats().snapshot().shapes)
    assert svc._degraded and svc.health().status == "degraded"
    assert all(h.degraded for h in handles[:8])
    svc.drain()
    assert not svc._degraded and svc.health().status == "ok"
    t = svc.telemetry.summary()
    assert t["degraded_flushes"] >= 1 and t["degraded_transitions"] >= 2
    svc.cfg.overload_queue_depth = None
    got = _stream(svc, workload)
    want = _exact(svc, workload)
    assert_same_results(got[1], got[0], want[1], want[0])


def test_drift_report_and_live_recall(state, workload, db):
    svc = _port(state, recall_reservoir=16)
    svc.insert(db.vectors[:20] + 0.01)
    _stream(svc, workload)
    _stream(svc, workload)
    rep = svc.drift_report(probe_recall=True)
    assert rep.n_window == 2 * workload.m and rep.delta_rows == 20
    assert rep.recall_samples == 16 and rep.recall_at_k == 1.0  # exact service
    assert abs(sum(rep.template_shares.values()) - 1.0) < 1e-9
    assert sum(rep.part_heat.values()) == pytest.approx(1.0)


def test_nprobe_by_filter_and_swap_match_reference(state, workload, db):
    """Per-filter nprobe overrides answer as the reference does; a
    blue/green swap (no WAL: the tail adopted from memory) keeps every
    write, and swapping back rolls back."""
    kw = dict(k=workload.k, nprobe=4, max_batch=16, deadline_s=0.0)
    ref = RefService(RefIndex.from_state(state), RefServiceConfig(**kw))
    port = HQIService(HQIIndex.from_state(state, device="cpu"), ServiceConfig(**kw))
    mapping = {f: 1 + i for i, f in enumerate(workload.templates)}
    for svc in (ref, port):
        svc.set_nprobe_by_filter(mapping)
    a, b = _stream(ref, workload), _stream(port, workload)
    assert_same_results(a[1], a[0], b[1], b[0])
    port.set_nprobe_by_filter(None)
    port.cfg.nprobe = EXACT
    ids = port.insert(db.vectors[:6] + 0.01)
    port.delete([3, int(ids[1])])
    before = _stream(port, workload)
    fresh = HQIIndex.from_state(state, device="cpu")
    old_index, old_live, old_seq, tail = port.swap_index(fresh, np.ones(db.n, bool), 0)
    assert tail == 6 and port.index is fresh and port.health().index_swaps == 1
    after = _stream(port, workload)
    assert_same_results(after[1], after[0], before[1], before[0])
    port.swap_index(old_index, old_live, old_seq)
    again = _stream(port, workload)
    assert_same_results(again[1], again[0], before[1], before[0])


def test_submit_completes_while_flush_in_flight(state, workload):
    """The kernel pipeline runs outside the state lock: submit / insert /
    delete during a flush queue into the next micro-batch. Synchronised by
    events and joins only."""
    svc = _port(state, max_batch=4)
    started, release = threading.Event(), threading.Event()
    orig_search = svc.index.search

    def held_search(*args, **kwargs):
        started.set()
        assert release.wait(timeout=60), "the test never released the flush"
        return orig_search(*args, **kwargs)

    svc.index.search = held_search
    for i in range(3):
        svc.submit(workload.vectors[i], workload.templates[workload.template_of[i]])
    flusher = threading.Thread(target=svc.flush)
    flusher.start()
    assert started.wait(timeout=60), "the flush never reached the engine"
    state_ = {}

    def writer():
        state_["h"] = svc.submit(workload.vectors[3], workload.templates[workload.template_of[3]])
        state_["ins"] = svc.insert(np.zeros((2, workload.vectors.shape[1]), dtype=np.float32))
        state_["del"] = svc.delete([0])

    w = threading.Thread(target=writer)
    w.start()
    w.join(timeout=60)
    assert not w.is_alive(), "writers blocked behind the in-flight flush"
    assert not state_["h"].done  # queued for the next micro-batch
    release.set()
    flusher.join(timeout=60)
    assert not flusher.is_alive()
    svc.index.search = orig_search
    assert svc.drain() == 1 and state_["h"].ok
    assert state_["del"] == 1 and len(state_["ins"]) == 2


def test_background_thread_answers_and_stops(state, workload):
    svc = _port(state, max_batch=8, deadline_s=0.001)
    svc.start(poll_s=0.001)
    try:
        handles = [svc.submit(workload.vectors[i], workload.templates[workload.template_of[i]])
                   for i in range(24)]
        for h in handles:
            assert h.wait(timeout=60), "the service thread never answered"
    finally:
        svc.stop()
    assert svc._thread is None and all(h.ok for h in handles)
    assert svc.telemetry.summary()["queries"] == 24


def test_wal_is_refused_until_the_store_is_ported(state):
    with pytest.raises(NotImplementedError, match="store/") as err:
        HQIService(HQIIndex.from_state(state, device="cpu"), ServiceConfig(), wal=object())
    assert str(err.value) == STORE_NOT_PORTED
