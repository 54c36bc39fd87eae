"""The port's store (snapshots, WAL, recovery, compaction) against the
reference's, on the CPU.

  * cross-load in both directions: a generation either package writes opens
    in the other and answers alike; a WAL either package writes replays in
    the other with the same seqs, kinds and arrays; both write manifests of
    the same keys, dtypes and shapes;
  * the same writes and queries through a port and a reference service, each
    with a WAL: the same answers, the same log, and each store recovers in
    the other package;
  * the cases of ``tests/test_store.py`` (snapshot round trips, fallback,
    pruning and pins, crash recovery, torn tails, CRC, rotation and
    compaction, group commit) and the store/WAL cases of
    ``tests/test_fault.py`` (fsync retry and poisoning, stage and apply
    faults, snapshot-write faults), held to the same invariants;
  * what is the port's own: ``build_state`` captures device tensors by
    reference, a loaded arena never aliases a read-only blob, and the
    default device ("cuda") fails without a card instead of loading
    elsewhere.
"""
import functools
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import repro.store as ref_store
from repro.core import HQIConfig as RefConfig
from repro.core import HQIIndex as RefIndex
from repro.core.predicates import filter_to_state as ref_filter_to_state
from repro.service import ServiceConfig as RefServiceConfig
from repro.store import wal as ref_wal
from repro_torch.core import HQIConfig, HQIIndex
from repro_torch.core.arena import PackedArena
from repro_torch.core.baselines import exhaustive_search
from repro_torch.core.predicates import NotNull, filter_from_state, make_filter
from repro_torch.core.types import Column, VectorDatabase, Workload
from repro_torch.fault import failpoints
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.service import ServiceConfig, ServiceReadOnly
from repro_torch.store import (
    Compactor,
    WalCorruptionError,
    WalPoisonedError,
    WriteAheadLog,
    build_state,
    init_store,
    list_generations,
    load_snapshot,
    open_service,
    pin_generation,
    pinned_generations,
    prune_generations,
    save_snapshot,
    unpin_generation,
    write_generation,
)
from repro_torch.store import wal as wal_mod
from repro_torch.store.wal import _HEADER, _MAGIC

from conftest import assert_same_results, small_db, small_workload

EXACT = 10_000  # nprobe past every list count: search becomes exact
CPU = "cpu"


@pytest.fixture(autouse=True)
def _disarm():
    failpoints.disarm_all()
    yield
    failpoints.disarm_all()


@functools.lru_cache(maxsize=None)
def _state(metric="ip", scan_mode=None, n=1500, seed=0, n_queries=40, leaves=8):
    """(db, the reference's workload, the same workload with the port's
    predicates, the reference index's state): one reference build per
    configuration, loaded into either package by ``from_state``. Each
    package searches with its own predicates, which its bitmap cache (and
    so its manifest) keys by. Tests that prune many generations take
    ``leaves=2``: fewer partitions, fewer blobs to delete."""
    db = small_db(n=n, d=16, seed=seed, metric=metric)
    wl = small_workload(db, n_queries=n_queries, seed=seed + 1)
    port_wl = Workload(
        vectors=wl.vectors, template_of=wl.template_of, k=wl.k,
        templates=[filter_from_state(ref_filter_to_state(f)) for f in wl.templates],
    )
    kw = dict(min_partition_size=128 if leaves > 2 else 600, max_leaves=leaves)
    if scan_mode == "pq":
        kw.update(scan_mode="pq", pq_m=4, refine_factor=4)
    return db, wl, port_wl, RefIndex.build(db, wl, RefConfig(**kw)).to_state()


def _build(metric="ip", scan_mode=None, **kw):
    db, _, wl, state = _state(metric, scan_mode, **kw)
    return db, wl, HQIIndex.from_state(state, device=CPU)


def _cfg_kw(wl, **over):
    kw = dict(k=wl.k, nprobe=EXACT, max_batch=16, deadline_s=0.0)
    kw.update(over)
    return kw


def _store(tmp_path, wl, hqi, **over):
    return init_store(str(tmp_path), hqi, cfg=ServiceConfig(**_cfg_kw(wl, **over)), device=CPU)


def _reopen(root, svc):
    return open_service(str(root), cfg=svc.cfg, device=CPU)


def _answers(svc, wl):
    handles = [svc.submit(wl.vectors[i], wl.templates[wl.template_of[i]]) for i in range(wl.m)]
    svc.drain()
    assert all(h.done for h in handles)
    return np.stack([h.ids for h in handles]), np.stack([h.scores for h in handles])


def _payload(rng, n, d):
    return (
        rng.normal(size=(n, d)).astype(np.float32),
        {
            "A": rng.random(n).astype(np.float32),
            "B": rng.random(n).astype(np.float32),
            "cat": rng.integers(0, 8, n).astype(np.int32),
            "tags": rng.random((n, 6)) < 0.5,
        },
    )


def _same_records(a, b):
    assert [(r.seq, r.kind) for r in a] == [(r.seq, r.kind) for r in b]
    for ra, rb in zip(a, b):
        assert sorted(ra.arrays) == sorted(rb.arrays)
        for key, arr in ra.arrays.items():
            assert arr.dtype == rb.arrays[key].dtype, key
            np.testing.assert_array_equal(arr, rb.arrays[key])


# ----------------------------------------------------------------- cross-load


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("scan_mode", [None, "pq"])
def test_reference_generation_opens_in_the_port(tmp_path, metric, scan_mode):
    """``repro.store.save_snapshot`` → the port's ``load_snapshot``: the
    loaded index answers like the reference's own."""
    db, wl, port_wl, state = _state(metric, scan_mode)
    ref = RefIndex.from_state(state)
    live = np.ones(db.n, dtype=bool)
    live[::7] = False
    ref.search(wl, nprobe=4)  # a bitmap cache in the generation
    ref_store.save_snapshot(str(tmp_path), ref, live=live, wal_seq=7)
    snap = load_snapshot(str(tmp_path), device=CPU)
    assert (snap.generation, snap.wal_seq) == (1, 7)
    np.testing.assert_array_equal(snap.live, live)
    a = ref.search(wl, nprobe=4, live_mask=live)
    b = snap.index.search(port_wl, nprobe=4, live_mask=snap.live)
    assert_same_results(a.scores, a.ids, b.scores, b.ids)


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("scan_mode", [None, "pq"])
def test_port_generation_opens_in_the_reference(tmp_path, metric, scan_mode):
    """The port's ``save_snapshot`` → ``repro.store.load_snapshot``: the
    reference answers like the port."""
    _, wl, port_wl, state = _state(metric, scan_mode)
    port = HQIIndex.from_state(state, device=CPU)
    a = port.search(port_wl, nprobe=4)
    save_snapshot(str(tmp_path), port, wal_seq=3)
    snap = ref_store.load_snapshot(str(tmp_path))
    assert (snap.generation, snap.wal_seq) == (1, 3)
    b = snap.index.search(wl, nprobe=4)
    assert_same_results(a.scores, a.ids, b.scores, b.ids)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_wal_replays_across_packages(tmp_path, writer):
    """A log written by either package — inserts with columns and null
    masks, deletes, a sealed segment, group-committed records, an open
    final segment — replays in the other with the same seqs, kinds and
    arrays, and the reader resumes the sequence."""
    write, read = ((ref_wal.WriteAheadLog, WriteAheadLog) if writer == "reference"
                   else (WriteAheadLog, ref_wal.WriteAheadLog))
    path = str(tmp_path / "wal")
    w = write(path)
    rng = np.random.default_rng(0)
    vecs, cols = _payload(rng, 5, 16)
    nm = {"B": rng.random(5) < 0.3}
    w.log_insert(vecs, np.arange(100, 105), cols, nm)
    w.log_delete([3, 101])
    w.rotate()
    seqs = [w.stage_insert(*_payload(rng, 2, 16)[:1], np.arange(105, 107)),
            w.stage_delete(np.array([104]))]
    w.sync_upto(seqs[-1])
    mine = list(w.replay(0))
    assert [r.seq for r in mine] == [1, 2, 3, 4]
    theirs = read(path)
    assert theirs.last_seq == 4 and len(theirs.segments()) == 2
    _same_records(list(theirs.replay(0)), mine)
    _same_records(list(theirs.replay(2)), mine[2:])
    assert theirs.log_delete([100]) == 5


@pytest.mark.parametrize("scan_mode", [None, "pq"])
def test_manifests_have_the_same_keys_dtypes_and_shapes(tmp_path, scan_mode):
    """For one index (searched once in each package, so both carry an arena
    and the same bitmap cache), the two packages' manifests agree in every
    key, blob name, dtype and shape, and in every scalar."""
    db, wl, port_wl, state = _state("ip", scan_mode)
    ref, port = RefIndex.from_state(state), HQIIndex.from_state(state, device=CPU)
    ref.search(wl, nprobe=4)
    port.search(port_wl, nprobe=4)
    live = np.ones(db.n, dtype=bool)
    ref_store.save_snapshot(str(tmp_path / "ref"), ref, live=live, wal_seq=2)
    save_snapshot(str(tmp_path / "port"), port, live=live, wal_seq=2)

    def manifest(root):
        with open(os.path.join(root, "gen-000001", "manifest.json")) as f:
            m = json.load(f)
        m.pop("created_unix")
        return m

    a, b = manifest(str(tmp_path / "ref")), manifest(str(tmp_path / "port"))
    assert a == b
    assert '"__npy__": "index.arena.packed.npy"' in json.dumps(b)


def test_services_log_alike_and_recover_across_packages(tmp_path):
    """The same inserts, deletes, refresh and queries through a port service
    and a reference service, each with a WAL: the same answers and the same
    log; then each store, crashed, recovers in the other package with its
    acknowledged writes and its answers."""
    db, wl, port_wl, state = _state("l2", None)
    port = init_store(str(tmp_path / "port"), HQIIndex.from_state(state, device=CPU),
                      cfg=ServiceConfig(**_cfg_kw(wl)), device=CPU)
    ref = ref_store.init_store(str(tmp_path / "ref"), RefIndex.from_state(state),
                               cfg=RefServiceConfig(**_cfg_kw(wl)))
    rng = np.random.default_rng(3)
    for step in range(2):
        vecs, cols = _payload(rng, 30, db.d)
        dead = rng.integers(0, db.n, 12)
        for svc in (port, ref):
            ids = svc.insert(vecs, cols)
            svc.delete(dead)
            svc.delete(ids[:4])
        if step == 0:
            port.refresh()
            ref.refresh()
    np.testing.assert_array_equal(port.live_ids(), ref.live_ids())
    (pi, ps), (ri, rs) = _answers(port, port_wl), _answers(ref, wl)
    assert_same_results(ps, pi, rs, ri)
    _same_records(list(port.wal.replay(0)), list(ref.wal.replay(0)))
    port.wal.close()
    ref.wal.close()

    ref_of_port = ref_store.open_service(str(tmp_path / "port"), cfg=ref.cfg)
    port_of_ref = open_service(str(tmp_path / "ref"), cfg=port.cfg, device=CPU)
    for svc, queries in ((ref_of_port, wl), (port_of_ref, port_wl)):
        np.testing.assert_array_equal(svc.live_ids(), port.live_ids())
        i, s = _answers(svc, queries)
        assert_same_results(s, i, ps, pi)


# --------------------------------------------------- the port's own behaviour


def test_build_state_captures_tensors_and_writes_the_same_generation(tmp_path):
    """``build_state`` keeps the arena's tensors as references (nothing read
    back under the caller's lock); ``write_generation`` copies them to the
    host and writes what ``save_snapshot`` writes."""
    _, wl, hqi = _build()
    hqi.search(wl, nprobe=4)
    st = build_state(hqi)
    arena = st["index"]["arena"]
    assert arena["packed"] is hqi.arena.packed and arena["gid"] is hqi.arena.gid
    write_generation(str(tmp_path / "a"), st, wal_seq=1)
    save_snapshot(str(tmp_path / "b"), hqi, wal_seq=1)
    for blob in os.listdir(tmp_path / "a" / "gen-000001" / "arrays"):
        x = np.load(tmp_path / "a" / "gen-000001" / "arrays" / blob)
        y = np.load(tmp_path / "b" / "gen-000001" / "arrays" / blob)
        assert x.dtype == y.dtype and np.array_equal(x, y), blob


def test_loaded_arena_never_aliases_a_blob(tmp_path):
    """A state whose arrays are read-only maps of blobs: the arena's tensors
    on the CPU are copies, so no tensor aliases a read-only mmap'd blob."""
    _, wl, hqi = _build()
    hqi.search(wl, nprobe=4)
    save_snapshot(str(tmp_path), hqi)
    arrays = tmp_path / "gen-000001" / "arrays"
    state = hqi.arena.to_state()
    for key in ("packed", "gid"):
        state[key] = np.load(arrays / f"index.arena.{key}.npy", mmap_mode="r")
    arena = PackedArena.from_state(state, device=CPU)
    for key in ("packed", "gid"):
        assert not np.shares_memory(getattr(arena, key).numpy(), state[key]), key
        np.testing.assert_array_equal(getattr(arena, key).numpy(), state[key])


def test_open_service_loads_onto_the_card_by_default(tmp_path):
    """``open_service`` and ``load_snapshot`` load onto "cuda" unless the
    caller asks for the CPU; on a machine without a card they fail rather
    than load elsewhere. ``init_store`` serves on "cuda" unless asked for
    the CPU, and refuses an index that lies elsewhere."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default load succeeds there")
    _, wl, hqi = _build()
    with pytest.raises(ValueError, match="the index is on cpu"):
        init_store(str(tmp_path), hqi)
    svc = _store(tmp_path, wl, hqi)
    svc.wal.close()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        open_service(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_snapshot(str(tmp_path))
    assert _reopen(tmp_path, svc).index.device.type == "cpu"


# ---------------------------------------------------- ports of test_store.py


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("scan_mode", [None, "pq"])
@pytest.mark.parametrize("mesh", [False, True])
def test_roundtrip_parity(tmp_path, metric, scan_mode, mesh):
    """build → save → load → bit-identical ids and scores (engine and
    per-query paths). With ``mesh`` the index searches on a two-rank CPU
    mesh; the snapshot drops the mesh (runtime wiring, not index state), and
    the loaded index, given the mesh again, answers bit-identically."""
    db, wl, hqi = _build(metric, scan_mode)
    two = make_test_mesh((2,), ("model",), device=CPU) if mesh else None
    hqi.cfg.mesh = two
    try:
        r0 = hqi.search(wl, nprobe=4)
        save_snapshot(str(tmp_path), hqi)
    finally:
        hqi.cfg.mesh = None
    loaded = load_snapshot(str(tmp_path), device=CPU).index
    assert loaded.cfg.mesh is None
    loaded.cfg.mesh = two
    r1 = loaded.search(wl, nprobe=4)
    assert (r0.shard_stats is None) == (r1.shard_stats is None) == (not mesh)
    np.testing.assert_array_equal(r0.ids, r1.ids)
    np.testing.assert_array_equal(r0.scores, r1.scores)
    o0, o1 = hqi.search_online(wl, nprobe=4), loaded.search_online(wl, nprobe=4)
    np.testing.assert_array_equal(o0.ids, o1.ids)
    np.testing.assert_array_equal(o0.scores, o1.scores)


def test_loaded_snapshot_is_warm(tmp_path):
    """Load restores the arena (rows + codes) and the Router bitmap cache."""
    _, wl, hqi = _build(scan_mode="pq")
    hqi.search(wl, nprobe=4)
    assert hqi.router._bitmap_cache
    save_snapshot(str(tmp_path), hqi)
    loaded = load_snapshot(str(tmp_path), device=CPU).index
    assert loaded._arena is not None
    assert loaded._arena.codes is not None and loaded._arena.pq is not None
    assert set(loaded.router._bitmap_cache) == set(hqi.router._bitmap_cache)
    for filt, bm in hqi.router._bitmap_cache.items():
        np.testing.assert_array_equal(bm, loaded.router._bitmap_cache[filt])


def test_roundtrip_after_extend(tmp_path):
    """A snapshot taken after live folds round-trips the grown index."""
    _, wl, hqi = _build()
    hqi.search(wl, nprobe=4)
    db = hqi.db
    new = db.take(np.arange(7))
    hqi.extend(VectorDatabase(
        vectors=new.vectors + 0.01, columns=new.columns, metric=db.metric,
        ids=db.n + np.arange(7, dtype=np.int64),
    ))
    r0 = hqi.search(wl, nprobe=EXACT)
    save_snapshot(str(tmp_path), hqi)
    r1 = load_snapshot(str(tmp_path), device=CPU).index.search(wl, nprobe=EXACT)
    np.testing.assert_array_equal(r0.ids, r1.ids)
    np.testing.assert_array_equal(r0.scores, r1.scores)


def test_generation_fallback_and_prune(tmp_path):
    """A torn newest generation is skipped; pruning keeps CURRENT loadable."""
    _, wl, hqi = _build(leaves=2)
    r0 = hqi.search(wl, nprobe=3)
    save_snapshot(str(tmp_path), hqi)
    save_snapshot(str(tmp_path), hqi)
    os.remove(tmp_path / "gen-000002" / "arrays" / "index.db.vectors.npy")
    snap = load_snapshot(str(tmp_path), device=CPU)
    assert snap.generation == 1
    np.testing.assert_array_equal(r0.ids, snap.index.search(wl, nprobe=3).ids)
    save_snapshot(str(tmp_path), hqi)  # gen 3, then torn by truncation
    with open(tmp_path / "gen-000003" / "arrays" / "index.db.vectors.npy", "r+b") as f:
        f.truncate(64)
    assert load_snapshot(str(tmp_path), device=CPU).generation == 1
    save_snapshot(str(tmp_path), hqi)  # gen 4
    prune_generations(str(tmp_path), keep=1)
    assert list_generations(str(tmp_path)) == ["gen-000004"]
    assert load_snapshot(str(tmp_path), device=CPU).generation == 4


def test_prune_keep_zero_and_pins(tmp_path):
    """``keep=0`` prunes everything but CURRENT and pinned generations;
    negative keep raises."""
    _, _, hqi = _build(leaves=2)
    for _ in range(4):
        save_snapshot(str(tmp_path), hqi)
    root = str(tmp_path)
    with pytest.raises(ValueError):
        prune_generations(root, keep=-1)
    pin_generation(root, "gen-000002")
    assert pinned_generations(root) == {"gen-000002"}
    assert sorted(prune_generations(root, keep=0)) == ["gen-000001", "gen-000003"]
    assert list_generations(root) == ["gen-000002", "gen-000004"]
    assert load_snapshot(root, device=CPU).generation == 4
    unpin_generation(root, "gen-000002")
    assert prune_generations(root, keep=0, pinned=("gen-000002",)) == []
    assert prune_generations(root, keep=0) == ["gen-000002"]
    assert list_generations(root) == ["gen-000004"]


def test_recovery_restores_acknowledged_writes(tmp_path):
    """Acknowledged inserts/deletes survive a crash with identical answers,
    and ids continue where the crashed process left off."""
    db, wl, hqi = _build(metric="l2")
    svc = _store(tmp_path, wl, hqi)
    ids_a = svc.insert(db.vectors[:5] + 0.01)
    svc.delete([int(ids_a[1]), 3, 3])
    ids_b = svc.insert(np.random.default_rng(7).normal(size=(4, db.d)).astype(np.float32))
    a_ids, a_scores = _answers(svc, wl)
    svc.wal.close()
    svc2 = _reopen(tmp_path, svc)
    assert svc2.n_live == svc.n_live
    np.testing.assert_array_equal(svc2.live_ids(), svc.live_ids())
    b_ids, b_scores = _answers(svc2, wl)
    np.testing.assert_array_equal(a_ids, b_ids)
    np.testing.assert_array_equal(a_scores, b_scores)
    assert int(svc2.insert(db.vectors[:1])[0]) == int(ids_b[-1]) + 1


def test_crash_mid_wal_append_drops_only_the_tail(tmp_path):
    """A record torn mid-append is dropped; every acknowledged one survives,
    and the log stays appendable."""
    db, wl, hqi = _build()
    svc = _store(tmp_path, wl, hqi)
    acked = svc.insert(db.vectors[:3] + 0.05)
    svc.delete([int(acked[2])])
    svc.wal.close()
    seg = os.path.join(str(tmp_path), "wal", svc.wal.segments()[-1])
    with open(seg, "ab") as f:
        f.write(_HEADER.pack(_MAGIC, 99, 1, 500, 0) + b"x" * 20)
    svc2 = _reopen(tmp_path, svc)
    live = set(svc2.live_ids().tolist())
    assert int(acked[0]) in live and int(acked[1]) in live and int(acked[2]) not in live
    nxt = svc2.insert(db.vectors[:1])
    assert int(nxt[0]) == int(acked[-1]) + 1
    assert int(nxt[0]) in set(_reopen(tmp_path, svc).live_ids().tolist())


def test_corrupt_payload_detected_by_crc(tmp_path):
    """Bit rot inside a sealed segment's payload raises."""
    db, wl, hqi = _build()
    svc = _store(tmp_path, wl, hqi)
    svc.insert(db.vectors[:2])
    svc.insert(db.vectors[2:4])
    svc.wal.close()
    seg = os.path.join(str(tmp_path), "wal", svc.wal.segments()[-1])
    with open(seg, "r+b") as f:
        f.seek(os.path.getsize(seg) - 24)
        f.write(b"\xff\xff\xff")
    with pytest.raises(WalCorruptionError, match="sealed segment"):
        open_service(str(tmp_path), device=CPU)


def test_refresh_rotates_and_compaction_prunes(tmp_path):
    """refresh() seals the segment; compaction snapshots at the fold point
    and prunes generations and covered segments; answers do not move."""
    db, wl, hqi = _build(leaves=2)
    svc = _store(tmp_path, wl, hqi)
    svc.insert(db.vectors[:4] + 0.01)
    assert len(svc.wal.segments()) == 1
    svc.refresh()
    svc.insert(db.vectors[4:6] + 0.01)
    assert len(svc.wal.segments()) == 2
    comp = Compactor(svc, str(tmp_path), keep_generations=1, min_delta_rows=1)
    assert comp.compact_once() == "gen-000002"
    assert comp.last_lock_s >= comp.last_capture_s > 0
    assert list_generations(str(tmp_path)) == ["gen-000002"]
    assert svc.wal.segments() == []
    svc.insert(db.vectors[6:7] + 0.01)
    assert len(svc.wal.segments()) == 1
    svc2 = _reopen(tmp_path, svc)
    a_ids, a_s = _answers(svc, wl)
    b_ids, b_s = _answers(svc2, wl)
    np.testing.assert_array_equal(a_ids, b_ids)
    np.testing.assert_array_equal(a_s, b_s)


def test_background_compactor_thread(tmp_path):
    """start()/stop() drives fold → snapshot cycles without answer drift."""
    db, wl, hqi = _build()
    svc = _store(tmp_path, wl, hqi)
    comp = Compactor(svc, str(tmp_path), interval_s=0.01, min_delta_rows=1)
    comp.start()
    rng = np.random.default_rng(11)
    for _ in range(4):
        svc.insert(rng.normal(size=(3, db.d)).astype(np.float32))
    comp.stop()
    assert comp._thread is None and comp.generations_written >= 1
    a_ids, a_s = _answers(svc, wl)
    b_ids, b_s = _answers(_reopen(tmp_path, svc), wl)
    np.testing.assert_array_equal(a_ids, b_ids)
    np.testing.assert_array_equal(a_s, b_s)


def test_seq_continues_after_full_wal_prune(tmp_path):
    """After compaction prunes every segment, a recovered service commits
    above the snapshot's seq, so the next recovery keeps its writes."""
    db, wl, hqi = _build(leaves=2)
    svc = _store(tmp_path, wl, hqi)
    svc.insert(db.vectors[:4] + 0.01)
    comp = Compactor(svc, str(tmp_path), keep_generations=1)
    comp.compact_once(force=True)
    comp.compact_once(force=True)
    assert svc.wal.segments() == []
    svc.wal.close()
    acked = _reopen(tmp_path, svc).insert(db.vectors[4:6] + 0.01)
    live = set(_reopen(tmp_path, svc).live_ids().tolist())
    assert int(acked[0]) in live and int(acked[1]) in live


def test_sealed_segment_corruption_is_not_truncated(tmp_path):
    """Rot in a sealed segment is kept on disk and refused at recovery."""
    db, wl, hqi = _build()
    svc = _store(tmp_path, wl, hqi)
    svc.insert(db.vectors[:2])
    svc.refresh()
    svc.insert(db.vectors[2:4])
    svc.wal.close()
    segs = svc.wal.segments()
    assert len(segs) == 2
    sealed = os.path.join(str(tmp_path), "wal", segs[0])
    size = os.path.getsize(sealed)
    with open(sealed, "r+b") as f:
        f.seek(size - 3)
        f.write(b"\xff\xff\xff")
    WriteAheadLog(os.path.join(str(tmp_path), "wal")).close()
    assert os.path.getsize(sealed) == size
    with pytest.raises(WalCorruptionError, match="sealed segment"):
        _reopen(tmp_path, svc)


def test_delete_only_interval_still_seals_and_prunes(tmp_path):
    """Tombstones of indexed rows are sealed and pruned by compaction."""
    db, wl, hqi = _build(leaves=2)
    svc = _store(tmp_path, wl, hqi)
    svc.delete(np.arange(0, 30, 3))
    assert Compactor(svc, str(tmp_path), keep_generations=1).compact_once(force=True)
    assert svc.wal.segments() == []
    svc.wal.close()
    svc2 = _reopen(tmp_path, svc)
    a_ids, a_s = _answers(svc, wl)
    b_ids, b_s = _answers(svc2, wl)
    np.testing.assert_array_equal(a_ids, b_ids)
    np.testing.assert_array_equal(a_s, b_s)
    assert svc2.n_live == svc.n_live


def test_fallback_when_blob_torn_inside_header_margin(tmp_path):
    """A blob short by less than the npy header fails at load: fall back."""
    _, wl, hqi = _build()
    r0 = hqi.search(wl, nprobe=3)
    save_snapshot(str(tmp_path), hqi)
    save_snapshot(str(tmp_path), hqi)
    blob = tmp_path / "gen-000002" / "arrays" / "index.db.vectors.npy"
    with open(blob, "r+b") as f:
        f.truncate(os.path.getsize(blob) - 40)
    snap = load_snapshot(str(tmp_path), device=CPU)
    assert snap.generation == 1
    np.testing.assert_array_equal(r0.ids, snap.index.search(wl, nprobe=3).ids)


def test_rejected_insert_is_never_logged(tmp_path):
    """A rejected insert leaves neither a log record nor visible rows."""
    db, wl, hqi = _build()
    svc = _store(tmp_path, wl, hqi)
    seq, n = svc.wal.last_seq, svc.n_live
    with pytest.raises(AssertionError, match="unknown columns"):
        svc.insert(db.vectors[:1], columns={"no_such_column": np.zeros(1)})
    assert svc.wal.last_seq == seq and svc.n_live == n
    assert _reopen(tmp_path, svc).n_live == n


def test_snapshot_handles_pathological_column_names(tmp_path):
    """Column names flow into blob file names; separators must not escape."""
    rng = np.random.default_rng(0)
    db = VectorDatabase(
        vectors=rng.normal(size=(600, 16)).astype(np.float32),
        columns={"a/b c": Column.numeric("a/b c", rng.random(600))},
        metric="ip",
    )
    wl = Workload(
        vectors=rng.normal(size=(8, 16)).astype(np.float32),
        templates=[make_filter(NotNull("a/b c"))],
        template_of=np.zeros(8, dtype=np.int32),
        k=5,
    )
    hqi = HQIIndex.build(db, wl, HQIConfig(min_partition_size=128, max_leaves=4), device=CPU)
    r0 = hqi.search(wl, nprobe=EXACT)
    save_snapshot(str(tmp_path), hqi)
    assert "a%2Fb%20c" in " ".join(os.listdir(tmp_path / "gen-000001" / "arrays"))
    r1 = load_snapshot(str(tmp_path), device=CPU).index.search(wl, nprobe=EXACT)
    np.testing.assert_array_equal(r0.ids, r1.ids)
    np.testing.assert_array_equal(r0.scores, r1.scores)


def test_init_store_over_reused_root_covers_stale_wal(tmp_path):
    """Re-bootstrapping over a used root does not replay the old records."""
    db, wl, hqi = _build()
    svc = _store(tmp_path, wl, hqi)
    svc.insert(db.vectors[:2] + 0.5)
    svc.wal.close()
    _, _, hqi2 = _build(seed=3)
    svc2 = _store(tmp_path, wl, hqi2)
    fresh = svc2.insert(db.vectors[2:4] + 0.5)
    svc2.wal.close()
    svc3 = _reopen(tmp_path, svc2)
    live = set(svc3.live_ids().tolist())
    assert int(fresh[0]) in live and int(fresh[1]) in live
    assert svc3.n_live == svc2.n_live
    np.testing.assert_array_equal(_answers(svc2, wl)[0], _answers(svc3, wl)[0])


def test_corruption_in_covered_segment_does_not_block_recovery(tmp_path):
    """Rot in a retained but snapshot-covered segment is skipped."""
    db, wl, hqi = _build()
    svc = _store(tmp_path, wl, hqi)
    svc.insert(db.vectors[:3] + 0.01)
    Compactor(svc, str(tmp_path), keep_generations=2).compact_once()
    covered = svc.wal.segments()
    assert len(covered) == 1
    acked = svc.insert(db.vectors[3:5] + 0.01)
    svc.wal.close()
    with open(os.path.join(str(tmp_path), "wal", covered[0]), "r+b") as f:
        f.seek(30)
        f.write(b"\xff\xff\xff")
    svc2 = _reopen(tmp_path, svc)
    live = set(svc2.live_ids().tolist())
    assert int(acked[0]) in live and int(acked[1]) in live
    assert svc2.n_live == svc.n_live


def test_wal_reopen_resumes_seq(tmp_path):
    """Reopening a WAL continues the sequence; replay(after_seq) filters."""
    wal = WriteAheadLog(str(tmp_path / "wal"))
    s1 = wal.log_insert(np.zeros((2, 4), np.float32), np.array([10, 11]))
    s2 = wal.log_delete([10])
    wal.close()
    wal2 = WriteAheadLog(str(tmp_path / "wal"))
    assert wal2.last_seq == s2 == 2
    s3 = wal2.log_delete([11])
    assert [r.seq for r in wal2.replay(after_seq=s1)] == [s2, s3]
    wal2.close()


def _count_fsync(monkeypatch):
    """Replace os.fsync with a counting stand-in; returns the call list."""
    calls = []
    real = os.fsync

    def counting(fd):
        calls.append(fd)
        return real(fd)

    monkeypatch.setattr(wal_mod.os, "fsync", counting)
    return calls


def _hold_first_fsync(monkeypatch, ready):
    """The first group-commit fsync (its ``wal.fsync`` failpoint, outside
    the WAL's lock) waits until ``ready()`` — every writer has staged — so
    the writers share that barrier whatever the threads' timing."""
    real = wal_mod.failpoint
    held = threading.Event()

    def failpoint(name):
        if name == "wal.fsync" and not held.is_set():
            t_end = time.monotonic() + 60.0
            while not ready():
                assert time.monotonic() < t_end, "the writers never staged"
                held.wait(0.001)
            held.set()
        real(name)

    monkeypatch.setattr(wal_mod, "failpoint", failpoint)


def _run_threads(threads):
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)


def test_group_commit_batches_fsyncs(tmp_path, monkeypatch):
    """Concurrent writers share durability barriers: the first fsync waits
    until every writer has staged a record, so T writers × B commits issue
    fewer fsyncs than commits; ids are unique, gap-free and in each
    writer's order, and recovery replays them all."""
    db, wl, hqi = _build()
    svc = _store(tmp_path, wl, hqi)
    T, B = 8, 6
    start_seq = svc.wal.last_seq
    calls = _count_fsync(monkeypatch)
    _hold_first_fsync(monkeypatch, lambda: svc.wal.last_seq >= start_seq + T)
    acked = [[] for _ in range(T)]

    def writer(t):
        rng = np.random.default_rng(100 + t)
        for _ in range(B):
            acked[t].append(int(svc.insert(rng.normal(size=(1, db.d)).astype(np.float32))[0]))

    _run_threads([threading.Thread(target=writer, args=(t,)) for t in range(T)])
    assert 1 <= len(calls) < T * B
    flat = sorted(x for lane in acked for x in lane)
    assert flat == list(range(flat[0], flat[0] + T * B))
    assert all(lane == sorted(lane) for lane in acked)
    svc.wal.close()
    svc2 = _reopen(tmp_path, svc)
    assert svc2.n_live == svc.n_live
    np.testing.assert_array_equal(svc2.live_ids(), svc.live_ids())


def test_group_commit_mixed_inserts_deletes(tmp_path, monkeypatch):
    """Concurrent inserts and deletes apply in log order: recovery lands on
    the same live set and the same answers."""
    db, wl, hqi = _build(metric="l2")
    svc = _store(tmp_path, wl, hqi)
    _count_fsync(monkeypatch)
    seed_ids = svc.insert(db.vectors[:12] + 0.01)

    def inserter(t):
        rng = np.random.default_rng(t)
        for _ in range(5):
            svc.insert(rng.normal(size=(2, db.d)).astype(np.float32))

    def deleter(t):
        for j in range(3):
            svc.delete([int(seed_ids[(t * 3 + j) % len(seed_ids)])])

    _run_threads([threading.Thread(target=inserter, args=(t,)) for t in range(4)]
                 + [threading.Thread(target=deleter, args=(t,)) for t in range(2)])
    a_ids, a_scores = _answers(svc, wl)
    svc.wal.close()
    svc2 = _reopen(tmp_path, svc)
    np.testing.assert_array_equal(svc2.live_ids(), svc.live_ids())
    b_ids, b_scores = _answers(svc2, wl)
    np.testing.assert_array_equal(a_ids, b_ids)
    np.testing.assert_array_equal(a_scores, b_scores)


def test_group_commit_fsync_failure_is_not_acknowledged(tmp_path, monkeypatch):
    """A failing barrier propagates to its commit, poisons the log (writes
    fail fast), and after the heal later commits land above the failed one."""
    db, wl, hqi = _build()
    svc = _store(tmp_path, wl, hqi)
    ok_ids = svc.insert(db.vectors[:2] + 0.01)
    real, fail = os.fsync, {"on": True}

    def flaky(fd):
        if fail["on"]:
            raise OSError("injected fsync failure")
        return real(fd)

    monkeypatch.setattr(wal_mod.os, "fsync", flaky)
    with pytest.raises(OSError, match="injected"):
        svc.insert(db.vectors[2:4] + 0.01)
    assert svc.wal.poisoned is not None
    with pytest.raises(ServiceReadOnly):
        svc.insert(db.vectors[4:6] + 0.01)
    fail["on"] = False
    svc.wal.clear_poison()
    later = svc.insert(db.vectors[4:6] + 0.01)
    assert int(later[0]) == int(ok_ids[-1]) + 3
    svc.wal.close()
    assert _reopen(tmp_path, svc).n_live == svc.n_live


def test_wal_stage_sync_api_direct(tmp_path, monkeypatch):
    """stage() orders frames; sync_upto() is idempotent and monotone; replay
    sees every staged record once, in order, across concurrent writers."""
    wal = WriteAheadLog(str(tmp_path / "wal"))
    T, B = 6, 10
    calls = _count_fsync(monkeypatch)
    _hold_first_fsync(monkeypatch, lambda: wal.last_seq >= T)

    def writer(t):
        for j in range(B):
            wal.sync_upto(wal.stage_delete(np.array([t * B + j], dtype=np.int64)))

    _run_threads([threading.Thread(target=writer, args=(t,)) for t in range(T)])
    assert len(calls) < T * B
    recs = list(wal.replay(0))
    assert [r.seq for r in recs] == list(range(1, T * B + 1))
    assert sorted(int(r.arrays["ids"][0]) for r in recs) == list(range(T * B))
    n = len(calls)
    wal.sync_upto(1)
    assert len(calls) == n
    wal.close()


# ------------------------------------- ports of test_fault.py's store cases


def _exact(svc, wl):
    """The exact answer over the service's live rows, in global ids."""
    snap, live = svc.snapshot_db(), svc.live_ids()
    res = exhaustive_search(snap, wl, device=CPU)
    return np.where(res.ids >= 0, live[np.maximum(res.ids, 0)], -1), res.scores


def test_wal_fsync_transient_fault_retried(tmp_path):
    """A transient fsync fault is absorbed by the retry budget."""
    db, wl, hqi = _build()
    svc = _store(tmp_path, wl, hqi)
    vecs, cols = _payload(np.random.default_rng(0), 3, db.d)
    with failpoints.armed("wal.fsync", "oserror", count=1):
        ids = svc.insert(vecs, cols)
    assert failpoints.fired("wal.fsync") == 1
    assert svc.wal.poisoned is None and svc.wal.synced_seq == svc._applied_seq
    assert set(ids.tolist()) <= set(svc.live_ids().tolist())


def test_wal_fsync_poison_quarantine_heal_and_replay(tmp_path, monkeypatch):
    """fsync failing past its budget in a group commit that two writers
    share: neither is acknowledged, the service turns read-only (reads
    serve), clear_poison() heals it, and recovery replays exactly the
    acknowledged writes. The two writers are made to share the one poisoned
    commit by events (the leader's fsync waits until both have staged),
    never by thread timing."""
    db, wl, hqi = _build()
    svc = _store(tmp_path, wl, hqi)
    rng = np.random.default_rng(1)
    vecs, cols = _payload(rng, 4, db.d)
    acked = svc.insert(vecs, cols)
    base = svc.wal.last_seq
    _hold_first_fsync(monkeypatch, lambda: svc.wal.last_seq >= base + 2)
    errs = {}

    def writer(name, seed):
        v, c = _payload(np.random.default_rng(seed), 2, db.d)
        try:
            svc.insert(v, c)
        except (OSError, WalPoisonedError) as e:
            errs[name] = e

    # the leader's barrier fails its whole budget and poisons the log; the
    # other writer, woken unsynced, leads the next barrier and fails its own
    with failpoints.armed("wal.fsync", "oserror", count=svc.wal.fsync_retries * 2):
        _run_threads([threading.Thread(target=writer, args=(n, 50 + n)) for n in range(2)])
    assert set(errs) == {0, 1}
    assert failpoints.fired("wal.fsync") == svc.wal.fsync_retries * 2
    assert svc.wal.poisoned is not None
    with pytest.raises(ServiceReadOnly):
        svc.insert(vecs, cols)
    with pytest.raises(ServiceReadOnly):
        svc.delete([0])
    h = svc.health()
    assert h.status == "read-only" and h.read_only and h.write_error
    _answers(svc, wl)  # reads keep serving
    svc.wal.clear_poison()
    assert svc.health().status == "ok"
    acked2 = svc.insert(*_payload(rng, 2, db.d))
    svc.wal.close()
    rec = _reopen(tmp_path, svc)
    live = set(rec.live_ids().tolist())
    assert set(acked.tolist()) <= live and set(acked2.tolist()) <= live
    got_i, got_s = _answers(rec, wl)
    exp_i, exp_s = _exact(rec, wl)
    assert_same_results(got_s, got_i, exp_s, exp_i)
    rec.wal.close()


def test_wal_stage_fault_releases_id_reservation(tmp_path):
    """A stage failure never reaches the log: the next insert gets the same
    ids and recovery agrees."""
    db, wl, hqi = _build()
    svc = _store(tmp_path, wl, hqi)
    vecs, cols = _payload(np.random.default_rng(2), 3, db.d)
    next_id = svc.index.db.n + svc.delta.n
    with failpoints.armed("wal.stage", "oserror"):
        with pytest.raises(OSError):
            svc.insert(vecs, cols)
    ids = svc.insert(vecs, cols)
    assert ids[0] == next_id
    svc.wal.close()
    rec = _reopen(tmp_path, svc)
    assert set(ids.tolist()) <= set(rec.live_ids().tolist())
    rec.wal.close()


def test_delta_apply_poison_heals_on_restart(tmp_path):
    """An apply failure after the log took the record quarantines the write
    path in-process; restart + replay heals it."""
    db, wl, hqi = _build()
    svc = _store(tmp_path, wl, hqi)
    vecs, cols = _payload(np.random.default_rng(3), 2, db.d)
    with failpoints.armed("delta.apply", "runtimeerror"):
        with pytest.raises(RuntimeError):
            svc.insert(vecs, cols)
    assert svc._write_poisoned is not None
    with pytest.raises(ServiceReadOnly):
        svc.insert(vecs, cols)
    assert svc.health().status == "read-only"
    _answers(svc, wl)  # reads unaffected
    logged_seq = svc.wal.last_seq
    svc.wal.close()
    rec = _reopen(tmp_path, svc)
    assert rec._applied_seq == logged_seq and rec.health().status == "ok"
    assert set(rec.insert(vecs, cols).tolist()) <= set(rec.live_ids().tolist())
    rec.wal.close()


def test_snapshot_write_fault_keeps_old_generation_current(tmp_path):
    """A snapshot-write fault past the budget leaves CURRENT, the
    generations and the segments as they were; the compactor backs off
    exponentially (capped) and a later success resets it."""
    db, wl, hqi = _build()
    svc = _store(tmp_path, wl, hqi)
    comp = Compactor(svc, str(tmp_path), interval_s=0.5, keep_generations=2)
    ids = svc.insert(*_payload(np.random.default_rng(4), 5, db.d))
    gens_before, segs_before = list_generations(str(tmp_path)), svc.wal.segments()
    current_before = (tmp_path / "CURRENT").read_text()
    with failpoints.armed("snapshot.write", "oserror", count=100):
        with pytest.raises(OSError):
            comp.compact_once(force=True)
    assert comp.consecutive_failures == 1 and comp.last_error is not None
    assert comp._backoff_s() == pytest.approx(comp.interval_s * 2.0)
    assert (tmp_path / "CURRENT").read_text() == current_before
    assert list_generations(str(tmp_path)) == gens_before
    assert svc.wal.segments() == segs_before
    assert svc.health().compactor_failures == 1
    assert load_snapshot(str(tmp_path), device=CPU).index is not None
    with failpoints.armed("snapshot.write", "oserror", count=100):
        for _ in range(2):
            with pytest.raises(OSError):
                comp.compact_once(force=True)
    assert comp.consecutive_failures == 3
    assert comp._backoff_s() == pytest.approx(comp.interval_s * 8.0)
    comp.max_backoff_s = 1.0
    assert comp._backoff_s() == 1.0
    assert comp.compact_once(force=True) is not None
    assert comp.consecutive_failures == 0 and comp.last_error is None
    assert svc.health().compactor_failures == 0
    assert set(ids.tolist()) <= set(load_snapshot(str(tmp_path), device=CPU).index.db.ids.tolist())
    svc.wal.close()


def test_snapshot_write_transient_fault_retried(tmp_path):
    """One blob-write fault inside the retry budget: the cycle still lands."""
    db, wl, hqi = _build()
    svc = _store(tmp_path, wl, hqi)
    comp = Compactor(svc, str(tmp_path))
    svc.insert(*_payload(np.random.default_rng(5), 3, db.d))
    with failpoints.armed("snapshot.write", "oserror", count=1):
        assert comp.compact_once(force=True) is not None
    assert comp.consecutive_failures == 0
    svc.wal.close()
