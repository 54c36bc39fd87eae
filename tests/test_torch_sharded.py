"""The port's sharded engine (``HQIConfig.mesh``) against its single-device
engine and the reference, on the CPU.

The reference's sharded engine is single-controller: one process runs
``shard_map`` over a mesh of (virtual host) devices. The port's is too: one
process drives every rank over a ``launch.mesh.Mesh`` of ``torch.device``s,
here every position on the CPU (``make_test_mesh((R,), ("model",),
device="cpu")``), with no process group, socket or port.

  * the ports of ``tests/test_engine_sharded.py`` (all nine) and of
    ``tests/test_distributed.py::test_distributed_hqi_search_matches_single_device``,
    over R in {1, 2, 4, 8} (7 for the uneven edge): both metrics, both scan
    modes, both merge layouts, bitmap pushdown, per-template ``nprobe``, the
    adaptive path. The port's sharded answers equal its single-device
    answers exactly (``np.array_equal``, scores and ids), and the reference's
    single-device engine (``use_pallas=False``) by ``assert_same_results``;
  * the numpy layers exactly against the reference: ``PackedArena.shard``
    (default and pinned bounds) and ``build_plan_sharded`` (each rank's
    units per pad);
  * the three draws that fail the reference's own property test (ROADMAP.md
    §3), exact here, and the property test itself with a fixed derandomized
    search and no example database;
  * the reference's sharded function itself, run in a subprocess on 4
    virtual host devices (``test_distributed.run_with_devices``), held
    against the port's sharded answers by ``assert_same_results``;
  * the gather merge's tie rule and sentinels, the shard views' invalidation,
    the profiler's rank rows and the spans.

Every global a test changes (dispatch stats, the profiler, the tracer) is
restored by a fixture or a ``finally``.
"""
import functools
import pickle

import numpy as np
import pytest
import torch

from repro.core import HQIConfig as RefConfig
from repro.core import HQIIndex as RefIndex
from repro.core import PackedArena as RefArena
from repro.core import build_plan_sharded as ref_build_plan_sharded
from repro.core.ivf import IVFIndex as RefIVF
from repro.core.plan import EngineTask as RefTask
from repro.core.plan import PlanConfig as RefPlan
from repro.core.planner import batch_search_ivf as ref_batch_search_ivf
from repro.core.pq import train_pq as ref_train_pq
from repro_torch.core import (
    HQIIndex,
    PackedArena,
    PlanConfig,
    build_plan,
    build_plan_sharded,
)
from repro_torch.core.distributed import ShardSpec, execute_sharded
from repro_torch.core.ivf import IVFIndex
from repro_torch.core.plan import EngineTask
from repro_torch.core.planner import batch_search_ivf, execute_plan
from repro_torch.core.pq import PQCodebook, train_pq
from repro_torch.core.predicates import Between, make_filter
from repro_torch.core.types import VectorDatabase, Workload
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.launch.mesh import Mesh, make_production_mesh, make_test_mesh
from repro_torch.obs import trace
from repro_torch.obs.profile import disable_profiler, enable_profiler
from repro_torch.service import HQIService, ServiceConfig

from conftest import assert_same_results, small_db, small_workload
from test_distributed import run_with_devices

MESH_SIZES = (1, 2, 4, 8)
CPU = "cpu"


def mesh_of(R: int) -> Mesh:
    return make_test_mesh((R,), ("model",), device=CPU)


def assert_exact(a_s, a_i, b_s, b_i, ctx=""):
    assert np.array_equal(a_s, b_s), f"scores diverge {ctx}"
    assert np.array_equal(a_i, b_i), f"ids diverge {ctx}"


@pytest.fixture
def dispatch():
    """The port's dispatch counters zeroed for the test, restored after it."""
    st = ops.dispatch_stats()
    saved = st.snapshot()
    st.reset()
    try:
        yield st
    finally:
        with st._lock:
            for f in ("knn_calls", "merge_calls", "shapes", "peak_candidate_bytes",
                      "lut_expand_bytes"):
                setattr(st, f, getattr(saved, f))


@functools.lru_cache(maxsize=None)
def _hqi_state(scan_mode=None, n=2000, seed=0, n_queries=60, leaves=32, metric="l2"):
    """(db, workload, the reference index's state): one reference build per
    configuration, loaded into either package by ``from_state``."""
    db = small_db(n=n, seed=seed, metric=metric)
    wl = small_workload(db, n_queries=n_queries, seed=seed + 1)
    kw = dict(min_partition_size=128, max_leaves=leaves,
              plan=RefPlan(adaptive_crossover=8, use_pallas=False))
    if scan_mode == "pq":
        kw.update(scan_mode="pq", pq_m=4)
    return db, wl, RefIndex.build(db, wl, RefConfig(**kw)).to_state()


def _port_hqi(**kw):
    db, wl, state = _hqi_state(**kw)
    return db, wl, HQIIndex.from_state(state, device=CPU), RefIndex.from_state(state)


@functools.lru_cache(maxsize=None)
def _ivf(n=900, seed=11, metric="ip", n_centroids=16, pq_m=0):
    """A reference IVF (and codebook) and the port's copy of it."""
    db = small_db(n=n, seed=seed, metric=metric)
    ref = RefIVF.build(db.vectors, metric=metric, n_centroids=n_centroids, seed=0)
    ref_pq = ref_train_pq(db.vectors, pq_m, metric=metric, iters=4, seed=0) if pq_m else None
    port = IVFIndex.from_state(ref.to_state(), device=CPU)
    pq = None if ref_pq is None else PQCodebook.from_state(ref_pq.to_state())
    return db, ref, port, ref_pq, pq


# ------------------------------------------------------------------ the mesh


def test_mesh_axes_and_devices():
    """A test mesh puts every position on one device; the engine's ranks are
    the devices along the model axis at index 0 of the others; the
    production mesh refuses to build on a machine without a card."""
    mesh = make_test_mesh((2, 4), ("data", "model"), device=CPU)
    assert mesh.shape == {"data": 2, "model": 4} and mesh.devices.shape == (2, 4)
    assert mesh.axis_devices("model") == [torch.device("cpu")] * 4
    assert ShardSpec().n_shards(mesh) == 4 and ShardSpec("data").n_shards(mesh) == 2
    assert ShardSpec().rank_devices(mesh) == [torch.device("cpu")] * 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_production_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            make_test_mesh((2,), ("model",), device="cuda")


# ------------------------------------------------- numpy layers vs reference


@pytest.mark.parametrize("layout", ["hqi", "ivf"])
@pytest.mark.parametrize("R", [1, 2, 3, 4, 7, 8])
def test_shard_bounds_match_reference(layout, R):
    """``PackedArena.shard``'s default split (and a pinned one) equals the
    reference's, list and row bounds alike, on a many-partition arena and
    on a standalone IVF's."""
    if layout == "hqi":
        _, _, port, ref = _port_hqi()
        pa, ra = port.arena, ref.arena
    else:
        _, ref_ivf, port_ivf, _, _ = _ivf()
        pa, ra = PackedArena.from_ivf(port_ivf), RefArena.from_ivf(ref_ivf)
    for bounds in (None, np.linspace(0, pa.n_lists, R + 1).astype(np.int64)):
        a, b = pa.shard(R, bounds=bounds), ra.shard(R, bounds=bounds)
        np.testing.assert_array_equal(a.list_bounds, b.list_bounds)
        np.testing.assert_array_equal(a.row_bounds, b.row_bounds)
        rows = np.arange(pa.n)
        np.testing.assert_array_equal(a.owner_of_row(rows), b.owner_of_row(rows))
        for r in range(R):
            sh = a.rank(r)
            assert sh.packed.data_ptr() == pa.packed[sh.row0:].data_ptr() or sh.n == 0
            np.testing.assert_array_equal(sh.gid.numpy(), pa.gid[sh.row0:sh.row0 + sh.n].numpy())


@pytest.mark.parametrize("R", [2, 5, 8])
def test_build_plan_sharded_matches_reference(R):
    """Each rank's units per pad equal the reference's: same tasks, lists,
    query rows and slots; the ranks partition the single plan's units."""
    db, wl, port, ref = _port_hqi()
    q = wl.vectors
    rng = np.random.default_rng(R)
    tasks, ref_tasks = [], []
    for p in range(min(6, len(port.partitions))):
        qrows = np.nonzero(rng.random(wl.m) < 0.6)[0].astype(np.int64)
        n_p = port.partitions[p].ivf.n
        pb = port.arena.packed_bitmap(p, rng.random(n_p) < 0.7)
        tasks.append(EngineTask(part=p, qrows=qrows, nprobe=4, packed_bitmap=pb))
        ref_tasks.append(RefTask(part=p, qrows=qrows, nprobe=4, packed_bitmap=pb))
    cfg = PlanConfig(tq_unit=8, min_list_pad=8)
    a = build_plan_sharded(port.arena.shard(R), tasks, q, m=wl.m, k=wl.k, cfg=cfg)
    b = ref_build_plan_sharded(ref.arena.shard(R), ref_tasks, q, m=wl.m, k=wl.k,
                               cfg=RefPlan(tq_unit=8, min_list_pad=8))
    assert a.pads == b.pads and a.n_dispatches == b.n_dispatches
    np.testing.assert_array_equal(a.per_rank_units, b.per_rank_units)
    assert a.per_rank_units.sum() == build_plan(port.arena, tasks, q, m=wl.m, k=wl.k,
                                                cfg=cfg).n_units
    for r in range(R):
        assert sorted(a.rank_buckets[r]) == sorted(b.rank_buckets[r])
        for lp, units in a.rank_buckets[r].items():
            for u, v in zip(units, b.rank_buckets[r][lp]):
                assert (u.task, u.glist) == (v.task, v.glist)
                np.testing.assert_array_equal(u.qrows, v.qrows)
                np.testing.assert_array_equal(u.slots, v.slots)


# ------------------------------------------ ports of test_engine_sharded.py


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_sharded_ivf_parity_f32(metric):
    """batch_search_ivf(mesh=...) == batch_search_ivf exactly, with and
    without bitmap pushdown, every mesh size; the reference's single-device
    answer agrees."""
    db, ref_ivf, ivf, _, _ = _ivf(seed=11, metric=metric)
    rng = np.random.default_rng(11)
    q = rng.normal(size=(23, db.d)).astype(np.float32)
    cfg = PlanConfig(tq_unit=8, min_list_pad=8)
    for bitmap in (None, rng.random(db.n) < 0.4):
        ss, si = batch_search_ivf(ivf, q, nprobe=6, k=5, bitmap=bitmap, cfg=cfg)
        rs, ri = ref_batch_search_ivf(ref_ivf, q, nprobe=6, k=5, bitmap=bitmap,
                                      cfg=RefPlan(tq_unit=8, min_list_pad=8, use_pallas=False))
        assert_same_results(rs, ri, ss, si)
        for R in MESH_SIZES:
            bs, bi = batch_search_ivf(ivf, q, nprobe=6, k=5, bitmap=bitmap, cfg=cfg, mesh=mesh_of(R))
            assert_exact(ss, si, bs, bi, f"{metric} R={R} bitmap={bitmap is not None}")


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_sharded_ivf_parity_pq(metric):
    """Compressed execution (ADC scan -> exact re-rank) sharded == single."""
    db, ref_ivf, ivf, ref_pq, pq = _ivf(seed=7, metric=metric, pq_m=4)
    rng = np.random.default_rng(7)
    q = rng.normal(size=(23, db.d)).astype(np.float32)
    cfg = PlanConfig(tq_unit=8, min_list_pad=8, scan_mode="pq", refine_factor=2)
    bitmap = rng.random(db.n) < 0.5
    for bm in (None, bitmap):
        ss, si = batch_search_ivf(ivf, q, nprobe=6, k=5, bitmap=bm, cfg=cfg, pq=pq)
        for R in MESH_SIZES:
            bs, bi = batch_search_ivf(ivf, q, nprobe=6, k=5, bitmap=bm, cfg=cfg, pq=pq,
                                      mesh=mesh_of(R))
            assert_exact(ss, si, bs, bi, f"pq {metric} R={R}")


@pytest.mark.parametrize("scan_mode", [None, "pq"])
def test_sharded_hqi_parity(scan_mode):
    """Full HQI workloads through cfg.mesh: multi-partition arena, template
    bitmaps, nprobe dicts, and the adaptive executor mixing sharded buckets
    with host-side per-query scans — all exact to mesh=None, and the
    reference's single-device engine agrees."""
    db, wl, hqi, ref = _port_hqi(scan_mode=scan_mode)
    nprobe_dict = {ti: 3 + (ti % 4) for ti in range(len(wl.templates))}
    refs = {}
    for bv in (True, "auto"):
        for npk in (False, True):
            np_ = nprobe_dict if npk else 6
            refs[(bv, npk)] = single = hqi.search(wl, nprobe=np_, batch_vec=bv)
            r = ref.search(wl, nprobe=np_, batch_vec=bv)
            assert_same_results(r.scores, r.ids, single.scores, single.ids)
    for R in MESH_SIZES:
        hqi.cfg.mesh = mesh_of(R)
        try:
            for (bv, npk), single in refs.items():
                res = hqi.search(wl, nprobe=(nprobe_dict if npk else 6), batch_vec=bv)
                assert_exact(single.scores, single.ids, res.scores, res.ids,
                             f"{scan_mode} R={R} bv={bv} npdict={npk}")
                st = res.shard_stats
                assert st is not None and st.n_shards == R
                assert st.per_rank_units.sum() > 0  # engine work ran sharded
                assert (res.tuples_scanned, res.bytes_scanned) == (
                    single.tuples_scanned, single.bytes_scanned)
        finally:
            hqi.cfg.mesh = None


def test_sharded_edge_cases():
    """Skewed splits, an empty shard, k larger than any shard's rows,
    all-false bitmaps, more ranks than the lists balance, and m=0 workloads
    all behave exactly like a single device."""
    rng = np.random.default_rng(3)
    db, _, ivf, _, _ = _ivf(n=700, seed=3, metric="l2", n_centroids=12)
    arena = PackedArena.from_ivf(ivf)
    q = rng.normal(size=(17, db.d)).astype(np.float32)
    cfg = PlanConfig(tq_unit=8, min_list_pad=8)
    k = 200  # > any shard's probed rows (3 lists x ~58 rows per query)
    ss, si = batch_search_ivf(ivf, q, nprobe=3, k=k, cfg=cfg)
    assert (si == -1).any()  # padding exists even on one device
    task = EngineTask(part=0, qrows=np.arange(17, dtype=np.int64), nprobe=3, packed_bitmap=None)
    G = arena.n_lists
    mesh = mesh_of(4)
    # skewed: rank 0 owns almost everything; an empty shard owns no rows
    for bounds in ([0, G - 2, G - 1, G - 1, G], [0, 0, 1, G - 1, G]):
        sharded = arena.shard(4, bounds=np.asarray(bounds))
        assert (sharded.rows_per_shard == 0).any()
        bs, bi, st = execute_sharded(sharded, [task], q, mesh=mesh, m=17, k=k, cfg=cfg)
        assert_exact(ss, si, bs, bi, f"bounds={bounds}")
        empty = sharded.rows_per_shard == 0
        assert (st.per_rank_units[empty] == 0).all()
        assert (st.per_rank_bytes[empty] == 0).all()
        assert np.isneginf(bs[bi < 0]).all()  # sentinels read (-inf, -1), not NEG_INF

    # more ranks than posting lists can absorb evenly: a non-pow2 mesh
    bs, bi, _ = execute_sharded(arena.shard(7), [task], q, mesh=mesh_of(7), m=17, k=k, cfg=cfg)
    assert_exact(ss, si, bs, bi, "R=7")

    # all-false bitmap through the HQI layer: (-inf, -1) everywhere
    _, wl0, hqi, _ = _port_hqi(leaves=16)
    hqi.cfg.mesh = mesh
    try:
        dead = Workload(
            vectors=wl0.vectors[:7],
            templates=[make_filter(Between("A", 5.0, 6.0))],  # A in [0,1): empty
            template_of=np.zeros(7, dtype=np.int32), k=4)
        res = hqi.search(dead, nprobe=6)
        assert (res.ids == -1).all() and np.isneginf(res.scores).all()
        none = Workload(vectors=np.zeros((0, db.d), np.float32), templates=[make_filter()],
                        template_of=np.zeros(0, dtype=np.int32), k=4)
        assert hqi.search(none, nprobe=6).ids.shape == (0, 4)
    finally:
        hqi.cfg.mesh = None


def test_sharded_comm_is_topk_gather_only():
    """The candidates crossing ranks are O(k·|model|) per query — constant in
    DB size — and per-rank scan bytes split the single-device scan."""
    rng = np.random.default_rng(5)
    cfg = PlanConfig(tq_unit=8, min_list_pad=8)
    k, m = 5, 16
    gathered = {}
    for n in (600, 2400):  # 4x the rows must not change the gather width
        vecs = rng.normal(size=(n, 24)).astype(np.float32)
        ivf = IVFIndex.from_state(RefIVF.build(vecs, metric="ip", n_centroids=24, seed=0)
                                  .to_state(), device=CPU)
        arena = PackedArena.from_ivf(ivf)
        q = rng.normal(size=(m, 24)).astype(np.float32)
        task = EngineTask(part=0, qrows=np.arange(m, dtype=np.int64), nprobe=8,
                          packed_bitmap=None)
        for R in (2, 8):
            _, _, st = execute_sharded(arena.shard(R), [task], q, mesh=mesh_of(R), m=m, k=k,
                                       cfg=cfg)
            gathered[(n, R)] = st.gathered_per_query
            assert st.gathered_per_query == R * k, st.gathered_per_query
            if n == 2400:
                _, _, st1 = execute_sharded(arena.shard(1), [task], q, mesh=mesh_of(1), m=m,
                                            k=k, cfg=cfg)
                total = st1.per_rank_bytes[0]
                assert st.per_rank_bytes.sum() == total  # same scan, split
                assert st.per_rank_bytes.max() <= 2.5 * total / R
    for R in (2, 8):
        assert gathered[(600, R)] == gathered[(2400, R)]  # O(k·R), not O(n)


@pytest.mark.parametrize("budget", [1, 2, 4])
def test_sharded_dispatch_budget(dispatch, budget):
    """One sharded scan dispatch per shared pad (<= max_bucket_shapes) and
    one segmented merge + one gather merge, whatever the mesh size; the
    shape ladder is the single-device ladder; ranks on one device launch
    the kernel once per bucket."""
    db, _, ivf, _, _ = _ivf(n=2000, seed=1, metric="l2", n_centroids=64)
    arena = PackedArena.from_ivf(ivf)
    q = np.random.default_rng(1).normal(size=(50, db.d)).astype(np.float32)
    task = EngineTask(part=0, qrows=np.arange(50, dtype=np.int64), nprobe=16, packed_bitmap=None)
    cfg = PlanConfig(max_bucket_shapes=budget, tq_unit=8, min_list_pad=8)
    single = build_plan(arena, [task], q, m=50, k=5, cfg=cfg)
    splan = build_plan_sharded(arena.shard(8), [task], q, m=50, k=5, cfg=cfg)
    assert splan.pads == sorted(single.buckets)
    assert splan.n_dispatches <= budget
    assert splan.per_rank_units.sum() == single.n_units
    s, i = batch_search_ivf(ivf, q, nprobe=16, k=5, cfg=cfg, mesh=mesh_of(8))
    assert 0 < dispatch.knn_calls <= budget, dispatch.knn_calls
    assert dispatch.merge_calls == 2, dispatch.merge_calls
    assert all(sh[0] == "sh" and sh[1] == 8 for sh in dispatch.shapes)
    ss, si = batch_search_ivf(ivf, q, nprobe=16, k=5, cfg=cfg)
    assert_exact(ss, si, s, i, f"budget={budget}")


def test_sharded_service_flushes():
    """HQIService flushes through the sharded engine when the index carries
    a mesh — the same answers as the single-device service, live inserts and
    deletes included, and after ``refresh()`` (the fold replaces the arena:
    the shard views must follow)."""
    db, wl, _ = _hqi_state(n=1200, seed=9, n_queries=24, leaves=16)

    def stream(svc):
        handles = [svc.submit(wl.vectors[i], wl.templates[wl.template_of[i]])
                   for i in range(wl.m)]
        svc.drain()
        return np.stack([h.ids for h in handles]), np.stack([h.scores for h in handles])

    rng = np.random.default_rng(2)
    newv = db.vectors[rng.integers(0, db.n, 8)] + 0.01 * rng.normal(
        size=(8, db.d)).astype(np.float32)
    dels = rng.integers(0, db.n, 20)  # ONE draw: both services mutate alike
    outs = {}
    for R in (None, 4):
        _, _, hqi, _ = _port_hqi(n=1200, seed=9, n_queries=24, leaves=16)
        hqi.cfg.mesh = None if R is None else mesh_of(R)
        svc = HQIService(hqi, ServiceConfig(k=wl.k, nprobe=8, max_batch=16, deadline_s=0.0,
                                            batch_vec=True))
        ids0, sc0 = stream(svc)
        svc.insert(newv)
        svc.delete(dels)
        ids1, sc1 = stream(svc)
        svc.refresh()
        ids2, sc2 = stream(svc)
        if R is not None:
            assert hqi._sharded is not None and hqi._sharded[1].base is hqi.arena
        outs[R] = (ids0, sc0, ids1, sc1, ids2, sc2)
    for a, b in zip(outs[None], outs[4]):
        assert np.array_equal(a, b)


def _draw(seed, n_parts, R, nprobe, with_bitmap, random_bounds):
    """The reference property test's body on the port: random partitions,
    tasks, bitmaps and shard bounds (the IVFs built by the reference and
    loaded, so both engines see one arena). Asserts exact parity and that
    the ranks partition the single plan's units; returns the single
    answers and the reference engine's."""
    rng = np.random.default_rng(seed)
    d, m, k = 8, 11, 4
    parts, ref_parts = [], []
    for p in range(n_parts):
        n_p = int(rng.integers(40, 400))
        vecs = rng.normal(size=(n_p, d)).astype(np.float32)
        ref_ivf = RefIVF.build(vecs, metric="ip", n_centroids=int(rng.integers(2, 12)), seed=0)
        rows = 10_000 * p + np.arange(n_p, dtype=np.int64)
        ref_parts.append((rows, ref_ivf))
        parts.append((rows, IVFIndex.from_state(ref_ivf.to_state(), device=CPU)))
    arena = PackedArena.from_partitions(parts, device=CPU)
    ref_arena = RefArena.from_partitions(ref_parts)
    q = rng.normal(size=(m, d)).astype(np.float32)
    cfg = PlanConfig(tq_unit=4, min_list_pad=8)
    tasks, ref_tasks = [], []
    for p, (rows, ivf) in enumerate(parts):
        qrows = np.nonzero(rng.random(m) < 0.7)[0].astype(np.int64)
        if len(qrows) == 0:
            continue
        bm = (rng.random(ivf.n) < 0.6) if with_bitmap else None
        pb = None if bm is None else arena.packed_bitmap(p, bm)
        np_ = int(min(nprobe, ivf.n_lists))
        tasks.append(EngineTask(part=p, qrows=qrows, nprobe=np_, packed_bitmap=pb))
        ref_tasks.append(RefTask(part=p, qrows=qrows, nprobe=np_, packed_bitmap=pb))
    single = build_plan(arena, tasks, q, m=m, k=k, cfg=cfg)
    ss, si = execute_plan(single, arena, q, cfg=cfg)
    bounds = None
    if random_bounds:
        G = arena.n_lists
        cuts = np.sort(rng.integers(0, G + 1, size=R - 1))
        bounds = np.concatenate([[0], cuts, [G]])
    sharded = arena.shard(R, bounds=bounds)
    splan = build_plan_sharded(sharded, tasks, q, m=m, k=k, cfg=cfg)
    assert splan.per_rank_units.sum() == single.n_units
    bs, bi, st = execute_sharded(sharded, tasks, q, mesh=mesh_of(R), m=m, k=k, cfg=cfg)
    assert_exact(ss, si, bs, bi, f"seed={seed}")
    assert st.per_rank_units.sum() == single.n_units
    from repro.core.planner import execute_plan as ref_execute_plan
    from repro.core.plan import build_plan as ref_build_plan

    ref_cfg = RefPlan(tq_unit=4, min_list_pad=8, use_pallas=False)
    rplan = ref_build_plan(ref_arena, ref_tasks, q, m=m, k=k, cfg=ref_cfg)
    rs, ri = ref_execute_plan(rplan, ref_arena, q, cfg=ref_cfg)
    return (ss, si), (rs, ri)


@pytest.mark.parametrize("random_bounds", [False, True])
@pytest.mark.parametrize("with_bitmap", [False, True])
@pytest.mark.parametrize("draw", [
    dict(seed=39268, n_parts=3, R=2, nprobe=1),
    dict(seed=1, n_parts=1, R=5, nprobe=4),
    dict(seed=5572, n_parts=2, R=2, nprobe=8),
], ids=["seed39268-parts3-R2-nprobe1", "seed1-parts1-R5", "seed5572-R2"])
def test_reference_failing_draws_are_exact(draw, with_bitmap, random_bounds):
    """The draws that break the reference's own ``test_sharded_property_parity``
    by 1–2 ulp (ROADMAP.md §3): the port's sharded answers are bit-identical
    to its single-device ones there, since each score is one ``fmaf`` chain
    whatever the stacking; the reference's single-device engine agrees."""
    (ss, si), (rs, ri) = _draw(**draw, with_bitmap=with_bitmap, random_bounds=random_bounds)
    assert_same_results(rs, ri, ss, si)


def test_sharded_property_parity():
    """Hypothesis: random workloads / partition layouts / shard bounds ->
    exact sharded-vs-single parity, and per-rank units partition the
    single-device plan's units. Derandomized, with no example database, so
    a run never replays a stored draw."""
    hyp = pytest.importorskip("hypothesis", reason="property tests need the [test] extra")
    st = pytest.importorskip("hypothesis.strategies")

    @hyp.settings(max_examples=12, deadline=None, database=None, derandomize=True)
    @hyp.given(
        seed=st.integers(0, 2**16),
        n_parts=st.integers(1, 3),
        R=st.sampled_from([1, 2, 3, 5, 8]),
        nprobe=st.integers(1, 8),
        with_bitmap=st.booleans(),
        random_bounds=st.booleans(),
    )
    def prop(seed, n_parts, R, nprobe, with_bitmap, random_bounds):
        _draw(seed, n_parts, R, nprobe, with_bitmap, random_bounds)

    prop()


@pytest.mark.parametrize("scan_mode", [None, "pq"])
def test_sharded_merge_layout_parity(dispatch, scan_mode):
    """merge_layout="segmented" == "dense" on the sharded path, bit for bit,
    across mesh sizes and skewed per-template routing; the segmented layout
    keeps lut_expand_bytes at 0 on the pq path, the dense one pays the
    expanded LUTs, and the per-rank ragged merge shrinks the buffer once
    ranks stack."""
    db, wl, hqi, _ = _port_hqi(scan_mode=scan_mode, n=1100, seed=21, n_queries=40)
    nprobe = {ti: (12 if ti == 0 else 1) for ti in range(len(wl.templates))}
    try:
        for R in MESH_SIZES:
            hqi.cfg.mesh = mesh_of(R)
            out = {}
            for layout in ("dense", "segmented"):
                hqi.cfg.plan.merge_layout = layout
                dispatch.reset()
                res = hqi.search(wl, nprobe=nprobe)
                out[layout] = (res, int(dispatch.peak_candidate_bytes),
                               int(dispatch.lut_expand_bytes))
            (dres, dense_peak, dense_lut), (sres, seg_peak, seg_lut) = out["dense"], out["segmented"]
            assert_exact(dres.scores, dres.ids, sres.scores, sres.ids, f"{scan_mode} R={R}")
            assert seg_lut == 0
            if scan_mode:
                assert dense_lut > 0
            if R >= 4:
                assert seg_peak < dense_peak, (R, seg_peak, dense_peak)
    finally:
        hqi.cfg.mesh = None
        hqi.cfg.plan.merge_layout = "segmented"


# ------------------------------------------ port of test_distributed.py


def test_distributed_hqi_search_matches_single_device():
    """HQI search through the sharded engine on a (data, model) mesh equals
    the single-device engine exactly; the data axis replicates."""
    db, wl, hqi, _ = _port_hqi()
    ref = hqi.search(wl, nprobe=6, batch_vec=True)
    hqi.cfg.mesh = make_test_mesh((2, 4), ("data", "model"), device=CPU)
    try:
        res = hqi.search(wl, nprobe=6, batch_vec=True)
    finally:
        hqi.cfg.mesh = None
    assert_exact(ref.scores, ref.ids, res.scores, res.ids)
    st = res.shard_stats
    assert st is not None and st.n_shards == 4
    assert st.gathered_per_query == 4 * wl.k, st.gathered_per_query
    assert st.per_rank_bytes.sum() > 0


# --------------------------------------------- the reference's sharded function


_REF_SHARDED = """
import pickle
import numpy as np, jax
from jax.sharding import Mesh
from repro.core import PackedArena
from repro.core.distributed import execute_sharded
from repro.core.ivf import IVFIndex
from repro.core.plan import EngineTask, PlanConfig
from repro.core.pq import train_pq

rng = np.random.default_rng(17)
vecs = rng.normal(size=(1500, 16)).astype(np.float32)
ivf = IVFIndex.build(vecs, metric="l2", n_centroids=24, seed=0)
pq = train_pq(vecs, 4, metric="l2", iters=4, seed=0)
arena = PackedArena.from_ivf(ivf)
arena.attach_pq(pq)
q = rng.normal(size=(31, 16)).astype(np.float32)
bitmap = rng.random(1500) < 0.6
task = EngineTask(part=0, qrows=np.arange(31, dtype=np.int64), nprobe=5,
                  packed_bitmap=arena.packed_bitmap(0, bitmap))
out = {"ivf": ivf.to_state(), "pq": pq.to_state(), "codes": arena.codes, "q": q,
       "bitmap": bitmap}
for mode in ("f32", "pq"):
    cfg = PlanConfig(tq_unit=8, min_list_pad=8, scan_mode=mode, refine_factor=3,
                     use_pallas=False)
    for R in (2, 4):
        mesh = Mesh(np.asarray(jax.devices()[:R]), ("model",))
        s, i, st = execute_sharded(arena.shard(R), [task], q, mesh=mesh, m=31, k=6, cfg=cfg)
        out[(mode, R)] = (s, i, st.per_rank_units, st.gathered_per_query)
with open(OUT, "wb") as f:
    pickle.dump(out, f)
"""


def test_matches_the_reference_sharded_function(tmp_path):
    """The reference's ``execute_sharded`` at R 2 and 4 (4 virtual host
    devices in a subprocess), f32 and PQ, on one seeded input with a bitmap:
    the port's sharded answers agree with it by ``assert_same_results`` (the
    reference is 1–2 ulp off itself at sharded shapes), and the ranks' unit
    counts and the gather width are the reference's."""
    out_path = tmp_path / "ref_sharded.pkl"
    run_with_devices(f"OUT = {str(out_path)!r}\n" + _REF_SHARDED, n=4)
    with open(out_path, "rb") as f:
        ref = pickle.load(f)
    ivf = IVFIndex.from_state(ref["ivf"], device=CPU)
    arena = PackedArena.from_ivf(ivf)
    arena.pq = PQCodebook.from_state(ref["pq"])
    arena.codes = torch.from_numpy(np.asarray(ref["codes"]))
    q = ref["q"]
    task = EngineTask(part=0, qrows=np.arange(31, dtype=np.int64), nprobe=5,
                      packed_bitmap=arena.packed_bitmap(0, ref["bitmap"]))
    for mode in ("f32", "pq"):
        cfg = PlanConfig(tq_unit=8, min_list_pad=8, scan_mode=mode, refine_factor=3)
        single = execute_plan(build_plan(arena, [task], q, m=31, k=6, cfg=cfg), arena, q, cfg=cfg)
        for R in (2, 4):
            s, i, st = execute_sharded(arena.shard(R), [task], q, mesh=mesh_of(R), m=31, k=6,
                                       cfg=cfg)
            rs, ri, units, gathered = ref[(mode, R)]
            assert_same_results(rs, ri, s, i)
            assert_exact(single[0], single[1], s, i, f"{mode} R={R}")
            np.testing.assert_array_equal(st.per_rank_units, units)
            assert st.gathered_per_query == gathered


# ---------------------------------------------------------- the port's own


def test_gather_merge_tie_rule_and_sentinels(dispatch):
    """``sharded_merge_topk`` is two hops under ``lax.top_k``'s rule: each
    rank's local top-k by (score desc, position asc), then the smallest
    position in the rank-major concatenation wins a tie; absent entries —
    padding -inf, a finite NEG_INF, an id of -1 — read (-inf, -1)."""
    mesh = mesh_of(3)
    s = [torch.tensor([[1.0, 2.0, 2.0, -float("inf")]]),
         torch.tensor([[2.0, NEG_INF, 3.0, 2.0]]),
         torch.tensor([[5.0, 2.0, 0.5, 7.0]])]
    i = [torch.tensor([[10, 11, 12, -1]]), torch.tensor([[20, -1, 22, 23]]),
         torch.tensor([[30, 31, -1, 33]])]
    top_s, top_i = ops.sharded_merge_topk(mesh, "model", s, i, 3)
    assert dispatch.merge_calls == 1
    # local top-3: r0 (2,11) (2,12) (1,10); r1 (3,22) (2,20) (2,23); r2 (7,33) (5,30) (2,31)
    np.testing.assert_array_equal(top_s.numpy(), [[7.0, 5.0, 3.0]])
    np.testing.assert_array_equal(top_i.numpy(), [[33, 30, 22]])
    top_s, top_i = ops.sharded_merge_topk(mesh, "model", s, i, 8)
    np.testing.assert_array_equal(top_i.numpy(), [[33, 30, 22, 11, 12, 20, 23, 31]])
    # a query with fewer candidates than k: the rest are (-inf, -1)
    s2 = [torch.tensor([[NEG_INF, -float("inf")]]), torch.tensor([[4.0, NEG_INF]])]
    i2 = [torch.tensor([[-1, -1]]), torch.tensor([[40, -1]])]
    top_s, top_i = ops.sharded_merge_topk(mesh_of(2), "model", s2, i2, 2)
    np.testing.assert_array_equal(top_i.numpy(), [[40, -1]])
    assert top_s[0, 0] == 4.0 and torch.isneginf(top_s[0, 1])


def test_sharded_scan_wrappers_group_by_device(dispatch):
    """Ranks that share a device make one kernel call over their units
    concatenated (each rank's slice back as its own, equal to scanning it
    alone); ranks without units get None and launch nothing."""
    g = torch.Generator().manual_seed(0)
    q = [torch.randn((4, 8, 16), generator=g) for _ in range(3)] + [None]
    v = [torch.randn((4, 32, 16), generator=g) for _ in range(3)] + [None]
    valid = [torch.rand((4, 32), generator=g) < 0.7 for _ in range(3)] + [None]
    live = [torch.tensor([8, 3, 0, 5], dtype=torch.int32)] * 3 + [None]
    res = ops.sharded_workunit_topk(mesh_of(4), "model", q, v, valid, 5, metric="l2", n_live=live)
    assert res[3] is None and dispatch.knn_calls == 1
    assert dispatch.shapes == {("sh", 4, 4, 8, 32, 5)}
    for r in range(3):
        want = ops.workunit_topk(q[r], v[r], valid[r], 5, metric="l2", n_live=live[r])
        assert torch.equal(res[r][0], want[0]) and torch.equal(res[r][1], want[1])


def test_shard_views_follow_extend_and_attach_pq():
    """Shard views are dropped when the arena changes (``extend``,
    ``attach_pq``, ``invalidate_caches``), so a later sharded search reads
    the new rows and codes and still equals the single-device search."""
    db, wl, hqi, _ = _port_hqi(n=1200, seed=9, n_queries=24, leaves=16)
    hqi.cfg.mesh = mesh_of(4)
    try:
        hqi.search(wl, nprobe=8)
        old = hqi._sharded[1]
        base = hqi.db
        new = base.take(np.arange(30))
        hqi.extend(VectorDatabase(vectors=new.vectors + 0.05, columns=new.columns,
                                  metric=base.metric, ids=base.n + np.arange(30, dtype=np.int64)))
        assert hqi._sharded is None
        res = hqi.search(wl, nprobe=8)
        assert hqi._sharded[1] is not old and hqi._sharded[1].base is hqi.arena
        hqi.cfg.mesh = None
        single = hqi.search(wl, nprobe=8)
        assert_exact(single.scores, single.ids, res.scores, res.ids, "after extend")
        hqi.attach_pq(train_pq(hqi.db.vectors, 4, metric=hqi.db.metric, iters=4, seed=0,
                               device=CPU))
        hqi.cfg.mesh = mesh_of(4)
        assert hqi._sharded is None
        res = hqi.search(wl, nprobe=8, scan_mode="pq")
        hqi.cfg.mesh = None
        single = hqi.search(wl, nprobe=8, scan_mode="pq")
        assert_exact(single.scores, single.ids, res.scores, res.ids, "after attach_pq")
        hqi.invalidate_caches()
        assert hqi._sharded is None
    finally:
        hqi.cfg.mesh = None


@pytest.mark.parametrize("scan_mode", [None, "pq"])
def test_sharded_profiler_rows_and_spans(scan_mode):
    """A sharded search under the profiler: every dispatch and merge
    attributed (coverage 1.0), one rank row per rank whose units sum to the
    plan's; the tracer sees the reference's sharded spans."""
    db, wl, hqi, _ = _port_hqi(scan_mode=scan_mode, n=1200, seed=9, n_queries=24, leaves=16)
    hqi.cfg.mesh = mesh_of(4)
    prof = enable_profiler()
    tracer = trace.enable()
    try:
        res = hqi.search(wl, nprobe=8)
        rep = prof.report()
    finally:
        trace.disable()
        disable_profiler()
        hqi.cfg.mesh = None
    assert rep["coverage"] == 1.0, rep
    assert sorted(rep["ranks"]) == ["0", "1", "2", "3"]
    assert sum(r["units"] for r in rep["ranks"].values()) == res.shard_stats.per_rank_units.sum()
    phases = {key.split("/")[0] + "/" + key.split("/")[1] for key in rep["phases"]}
    want = {"scan/sharded-pq" if scan_mode else "scan/sharded-f32", "merge/segmented",
            "gather/sharded"}
    if scan_mode:
        want.add("rerank/sharded")
    assert want <= phases, phases
    names = {(e["name"], e.get("args", {}).get("mode")) for e in tracer.events()
             if e.get("ph") == "X"}
    assert ("plan.execute", "sharded") in names
    for span in ("merge.gather", "merge.segmented", "dispatch.sharded"):
        assert any(n == span for n, _ in names), (span, names)
    if scan_mode:
        assert ("rerank.exact", "sharded") in names
