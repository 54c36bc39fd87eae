"""The port's index-evolution tuner, on the CPU: the cases of
``tests/test_tuner.py``, each held to the same invariant.

  * a template shift trips the tuner, which rebuilds off to the side (on the
    serving index's device) and swaps with zero dropped queries; answers
    stay equal to an unswapped service's in exhaustive mode;
  * writes acknowledged between capture and swap replay from the WAL with
    id continuity, and recovery from the promoted generation agrees;
  * a faulted build or swap leaves the old index serving and ``CURRENT``
    unflipped; ``rollback()`` keeps writes acknowledged after the swap.

The data are ``conftest``'s, converted to the port's types (database and
predicates) through their state, so every object the tuner sees is the
port's own.
"""
import threading
import time

import numpy as np
import pytest

from repro_torch.core import HQIConfig, HQIIndex
from repro_torch.core.predicates import filter_from_state
from repro_torch.core.types import VectorDatabase, Workload
from repro_torch.core.workload import reconstruct_workload
from repro_torch.fault import failpoints
from repro_torch.obs.drift import DriftReport
from repro_torch.service import HQIService, ServiceConfig
from repro_torch.store import init_store, list_generations, open_service
from repro_torch.store.snapshot import current_generation, pinned_generations
from repro_torch.tuner import Tuner, TunerConfig
from repro.core.predicates import filter_to_state as ref_filter_to_state

from conftest import assert_same_results, small_db, small_workload

EXACT = 10_000  # nprobe past every list count: search becomes exact
CPU = "cpu"


@pytest.fixture(autouse=True)
def _disarm():
    failpoints.disarm_all()
    yield
    failpoints.disarm_all()


def _data(n, seed, n_queries):
    """conftest's database and workload in the port's types."""
    ref_db = small_db(n=n, seed=seed)
    ref_wl = small_workload(ref_db, n_queries=n_queries)
    wl = Workload(
        vectors=ref_wl.vectors, template_of=ref_wl.template_of, k=ref_wl.k,
        templates=[filter_from_state(ref_filter_to_state(f)) for f in ref_wl.templates],
    )
    return VectorDatabase.from_state(ref_db.to_state()), wl


def _build_index(db, wl):
    return HQIIndex.build(db, wl, HQIConfig(min_partition_size=128, max_leaves=16), device=CPU)


def _cfg(wl, **over):
    kw = dict(k=wl.k, nprobe=EXACT, max_batch=16, deadline_s=0.0)
    kw.update(over)
    return ServiceConfig(**kw)


def _service(db, wl, **over):
    return HQIService(_build_index(db, wl), _cfg(wl, **over))


def _store(root, db, wl):
    return init_store(str(root), _build_index(db, wl), cfg=_cfg(wl), device=CPU)


def _stream(svc, wl, rows=None):
    rows = range(wl.m) if rows is None else rows
    handles = [svc.submit(wl.vectors[i], wl.templates[wl.template_of[i]]) for i in rows]
    svc.drain()
    assert all(h.ok for h in handles)  # zero dropped / failed queries
    return np.stack([h.ids for h in handles]), np.stack([h.scores for h in handles])


def _report(**over):
    base = dict(
        n_window=500, window_span_s=10.0, template_shares={}, reference_shares={},
        share_shift=0.0, part_heat={}, delta_rows=0, delta_growth_per_s=0.0,
    )
    base.update(over)
    return DriftReport(**base)


def test_shift_triggers_swap_with_exact_parity_and_zero_drops():
    db, wl = _data(1500, 5, 48)
    svc, ref = _service(db, wl), _service(db, wl)
    tuner = Tuner(svc, cfg=TunerConfig(min_window=32, share_shift=0.5, retune_nprobe=False))
    assert tuner.tune_once() is None  # stationary start: no trigger
    _stream(svc, wl, np.repeat(np.where(wl.template_of <= 2)[0], 2))  # phase A
    _stream(svc, wl, np.repeat(np.where(wl.template_of >= 3)[0], 2))  # phase B
    rec = tuner.tune_once()
    assert rec is not None and rec.reason == "share-shift"
    assert rec.n_rows == db.n and rec.swap_s >= 0.0
    assert svc.index.device.type == "cpu"  # rebuilt on the serving index's device
    assert svc.health().index_swaps == 1
    assert svc.telemetry.summary()["index_swaps"] == 1.0
    assert svc.drift_report().n_window == 0
    assert tuner.tune_once() is None
    s_ids, s_scores = _stream(svc, wl)
    r_ids, r_scores = _stream(ref, wl)
    assert_same_results(s_scores, s_ids, r_scores, r_ids)


def test_swap_preserves_inflight_queued_queries():
    """Queries queued across the swap answer on the new index, exactly."""
    db, wl = _data(900, 2, 24)
    svc = _service(db, wl, max_batch=1000, deadline_s=1000.0)  # nothing auto-flushes
    ref = _service(db, wl)
    tuner = Tuner(svc, cfg=TunerConfig(retune_nprobe=False))
    handles = [svc.submit(wl.vectors[i], wl.templates[wl.template_of[i]]) for i in range(wl.m)]
    assert not any(h.done for h in handles)
    assert tuner.tune_once(force=True) is not None
    svc.drain()
    assert all(h.ok for h in handles)
    r_ids, r_scores = _stream(ref, wl)
    assert_same_results(np.stack([h.scores for h in handles]), np.stack([h.ids for h in handles]),
                        r_scores, r_ids)


def test_scripted_swap_wal_continuity_bit_identical(tmp_path):
    """Writes acked after capture and before the swap replay into the new
    layout with id continuity; recovery from the promoted generation agrees."""
    db, wl = _data(900, 3, 24)
    rng = np.random.default_rng(9)
    svc = _store(tmp_path, db, wl)
    ref = _service(db, wl)  # same writes, never swapped
    tuner = Tuner(svc, str(tmp_path), cfg=TunerConfig(retune_nprobe=False))
    v1 = rng.normal(size=(5, db.d)).astype(np.float32)
    ids1 = svc.insert(v1)
    np.testing.assert_array_equal(ids1, ref.insert(v1))
    built = tuner._build("forced")
    assert built.covered_seq == svc._applied_seq
    assert built.index.db.n == db.n + 5
    v2 = rng.normal(size=(4, db.d)).astype(np.float32)
    ids2 = svc.insert(v2)
    np.testing.assert_array_equal(ids2, ref.insert(v2))
    dels = [int(ids1[0]), 7]
    assert svc.delete(dels) == ref.delete(dels) == 2
    rec = tuner._swap(built)
    assert rec.replayed == 2
    assert svc._wal_folded_seq == built.covered_seq
    np.testing.assert_array_equal(svc.live_ids(), ref.live_ids())
    v3 = rng.normal(size=(2, db.d)).astype(np.float32)
    np.testing.assert_array_equal(svc.insert(v3), ref.insert(v3))
    s_ids, s_scores = _stream(svc, wl)
    r_ids, r_scores = _stream(ref, wl)
    assert_same_results(s_scores, s_ids, r_scores, r_ids)
    svc2 = open_service(str(tmp_path), cfg=_cfg(wl), device=CPU)
    np.testing.assert_array_equal(svc2.live_ids(), ref.live_ids())
    s2_ids, s2_scores = _stream(svc2, wl)
    assert_same_results(s2_scores, s2_ids, r_scores, r_ids)


def test_swap_under_concurrent_inserts_loses_no_acked_write(tmp_path):
    """A writer thread runs through the whole tune: every acknowledged insert
    survives the swap and the recovery, and no id is handed out twice. The
    writer is known to be running (five acks) before the tune starts."""
    db, wl = _data(700, 4, 12)
    svc = _store(tmp_path, db, wl)
    tuner = Tuner(svc, str(tmp_path), cfg=TunerConfig(retune_nprobe=False))
    rng = np.random.default_rng(11)
    acked, stop, five = [], threading.Event(), threading.Event()

    def writer():
        while not stop.is_set():
            acked.extend(int(i) for i in svc.insert(rng.normal(size=(1, db.d)).astype(np.float32)))
            if len(acked) >= 5:
                five.set()

    t = threading.Thread(target=writer)
    t.start()
    try:
        assert five.wait(60)
        rec = tuner.tune_once(force=True)
    finally:
        stop.set()
        t.join(timeout=60)
    assert not t.is_alive() and rec is not None
    assert set(acked) <= set(int(i) for i in svc.live_ids())
    assert len(acked) == len(set(acked))
    _stream(svc, wl)
    svc2 = open_service(str(tmp_path), device=CPU)
    assert set(acked) <= set(int(i) for i in svc2.live_ids())


def test_build_failpoint_leaves_old_index_serving():
    db, wl = _data(700, 6, 12)
    svc = _service(db, wl)
    old_index = svc.index
    tuner = Tuner(svc, cfg=TunerConfig(retune_nprobe=False))
    with failpoints.armed("tuner.build", "runtimeerror"):
        with pytest.raises(RuntimeError):
            tuner.tune_once(force=True)
    assert svc.index is old_index and svc.health().index_swaps == 0
    assert tuner.consecutive_failures == 1 and svc.health().tuner_failures == 1
    assert "RuntimeError" in svc.health().tuner_error
    _stream(svc, wl)
    assert tuner.tune_once(force=True) is not None
    assert tuner.consecutive_failures == 0 and tuner.last_error is None


def test_swap_failpoint_leaves_current_unflipped_then_retry_succeeds(tmp_path):
    db, wl = _data(700, 7, 12)
    svc = _store(tmp_path, db, wl)
    old_index = svc.index
    tuner = Tuner(svc, str(tmp_path), cfg=TunerConfig(retune_nprobe=False))
    ids = svc.insert(np.random.default_rng(0).normal(size=(3, db.d)).astype(np.float32))
    with failpoints.armed("tuner.swap", "oserror", count=1):
        with pytest.raises(OSError):
            tuner.tune_once(force=True)
    assert svc.index is old_index
    assert current_generation(str(tmp_path)) == "gen-000001"
    assert len(list_generations(str(tmp_path))) == 2  # the candidate parked on disk
    assert set(int(i) for i in ids) <= set(int(i) for i in svc.live_ids())
    _stream(svc, wl)
    rec = tuner.tune_once(force=True)
    assert rec is not None and current_generation(str(tmp_path)) == rec.generation
    assert pinned_generations(str(tmp_path)) == {"gen-000001"}
    assert svc.health().index_swaps == 1


def test_rollback_preserves_post_swap_writes(tmp_path):
    db, wl = _data(700, 8, 12)
    svc = _store(tmp_path, db, wl)
    tuner = Tuner(svc, str(tmp_path), cfg=TunerConfig(retune_nprobe=False))
    with pytest.raises(RuntimeError):
        tuner.rollback()
    pre_ids, pre_scores = _stream(svc, wl)
    rec = tuner.tune_once(force=True)
    assert current_generation(str(tmp_path)) == rec.generation
    tuner.rollback()  # answers as before the swap
    ids, scores = _stream(svc, wl)
    np.testing.assert_array_equal(ids, pre_ids)
    np.testing.assert_array_equal(scores, pre_scores)
    rec = tuner.tune_once(force=True)
    new = svc.insert(np.random.default_rng(1).normal(size=(4, db.d)).astype(np.float32))
    before = set(int(i) for i in svc.live_ids())
    tuner.rollback()
    assert set(int(i) for i in svc.live_ids()) == before
    assert set(int(i) for i in new) <= before
    assert current_generation(str(tmp_path)) == "gen-000001"
    assert pinned_generations(str(tmp_path)) == set()
    assert svc.wal.pin_seq is None and svc._nprobe_by_filter is None
    _stream(svc, wl)
    assert svc.health().index_swaps == 4  # each rollback is itself a swap


def test_should_rebuild_thresholds_and_cooldown():
    tuner = Tuner.__new__(Tuner)  # should_rebuild only reads cfg + cooldown
    tuner.cfg = TunerConfig(share_shift=0.3, recall_floor=0.7, delta_growth_per_s=100.0,
                            min_window=64, min_interval_s=1000.0)
    tuner._last_swap_t = None
    assert tuner.should_rebuild(_report(n_window=10, share_shift=0.9)) is None
    assert tuner.should_rebuild(_report(share_shift=0.31)) == "share-shift"
    assert tuner.should_rebuild(_report(recall_at_k=0.5)) == "recall-sag"
    assert tuner.should_rebuild(_report(delta_growth_per_s=150.0)) == "delta-growth"
    assert tuner.should_rebuild(_report(recall_at_k=0.9)) is None
    tuner._last_swap_t = time.monotonic()
    assert tuner.should_rebuild(_report(share_shift=0.9)) is None


def test_retune_installs_filter_keyed_nprobe():
    db, wl = _data(700, 10, 30)
    svc = _service(db, wl, nprobe=2)
    ref = _service(db, wl)
    _stream(svc, wl)  # two passes: the reconstruction reads the recent half
    _stream(svc, wl)
    tuner = Tuner(svc, cfg=TunerConfig(retune_nprobe=True, target_recall=1.0, max_nprobe=EXACT,
                                       workload_queries=64, sample_per_template=8))
    rec = tuner.tune_once(force=True)
    assert rec.nprobe_by_filter is not None
    assert set(rec.nprobe_by_filter) == set(wl.templates)
    assert svc._nprobe_by_filter == rec.nprobe_by_filter
    s_ids, s_scores = _stream(svc, wl)
    r_ids, r_scores = _stream(ref, wl)
    assert_same_results(s_scores, s_ids, r_scores, r_ids)
    svc.set_nprobe_by_filter(None)
    assert svc._nprobe_by_filter is None


def test_reconstruct_workload_shares_vectors_determinism():
    fa, fb = (("A", 1),), (("B", 2),)
    traffic = [(0.0, fa)] * 6 + [(0.0, fb)] * 2
    vec = np.full(4, 7.0, np.float32)
    samples = [(vec, fa, np.array([1]))]
    fallback = np.zeros((10, 4), np.float32)
    wl = reconstruct_workload(traffic, samples, fallback_vectors=fallback, n_queries=8)
    assert wl is not None and set(wl.templates) == {fa, fb}
    counts = {wl.templates[t]: int((wl.template_of == t).sum()) for t in range(2)}
    assert counts[fa] == 6 and counts[fb] == 2
    np.testing.assert_array_equal(
        wl.vectors[wl.template_of == wl.templates.index(fa)], np.tile(vec, (6, 1)))
    wl2 = reconstruct_workload(traffic, samples, fallback_vectors=fallback, n_queries=8)
    np.testing.assert_array_equal(wl.vectors, wl2.vectors)
    assert wl.templates == wl2.templates
    rare = [(0.0, fa)] * 99 + [(0.0, fb)]
    wl3 = reconstruct_workload(rare, (), fallback_vectors=fallback, n_queries=10)
    assert (wl3.template_of == wl3.templates.index(fb)).sum() == 1
    assert reconstruct_workload([], (), fallback_vectors=fallback) is None
