"""Live updates of the port against the reference, on the CPU:
``IVFIndex.extend``, ``PackedArena.updated``, ``HQIIndex.extend`` and
``invalidate_caches``. Each reference index is loaded into the port through
``to_state()``, so both sides extend the same partitioning."""
import numpy as np
import pytest

from repro.core import HQIConfig as RefConfig
from repro.core import HQIIndex as RefIndex
from repro.core import IVFIndex as RefIVF
from repro.core.types import Column as RefColumn
from repro.core.types import VectorDatabase as RefDB
from repro_torch.core import arena as arena_mod
from repro_torch.core.arena import PackedArena
from repro_torch.core.hqi import HQIIndex
from repro_torch.core.ivf import IVFIndex
from repro_torch.core.types import Column, VectorDatabase

from conftest import assert_same_results, small_db, small_workload

CFG = dict(min_partition_size=128, max_leaves=16)


def _new_rows(db, n, seed, columns=Column, vdb=VectorDatabase):
    """``n`` rows near seeded-random existing rows (+0.01 noise) with random
    column values, as ``columns``/``vdb`` (the port's or the reference's)."""
    rng = np.random.default_rng(seed)
    vecs = db.vectors[rng.integers(0, db.n, n)] + 0.01 * rng.normal(size=(n, db.d)).astype(
        np.float32)
    null = rng.random(n) < 0.3
    return vdb(
        vectors=vecs,
        columns={
            "A": columns.numeric("A", rng.random(n).astype(np.float32)),
            "B": columns.numeric("B", rng.random(n).astype(np.float32), null_mask=null),
            "cat": columns.categorical("cat", rng.integers(0, 8, n).astype(np.int32)),
            "tags": columns.setcat("tags", rng.random((n, 6)) < 0.4),
        },
        metric=db.metric,
    )


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_ivf_extend_matches_reference(metric):
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(800, 12)).astype(np.float32)
    ref = RefIVF.build(vecs, metric=metric, n_centroids=16)
    port = IVFIndex.from_state(ref.to_state(), device="cpu")
    new = rng.normal(size=(150, 12)).astype(np.float32)
    a, b = ref.extend(new), port.extend(new)
    np.testing.assert_array_equal(a.order, b.order)
    np.testing.assert_array_equal(a.offsets, b.offsets)
    np.testing.assert_array_equal(a.packed, b.packed)
    np.testing.assert_array_equal(a.centroids, b.centroids)
    assert port.extend(new[:0]) is port


@pytest.fixture(scope="module", params=["ip", "l2"])
def built(request):
    db = small_db(n=1500, seed=5, metric=request.param)
    wl = small_workload(db, n_queries=48)
    return db, wl, RefIndex.build(db, wl, RefConfig(**CFG)).to_state()


@pytest.mark.parametrize("arena", ["resident", "not built"])
def test_hqi_extend_matches_reference(built, arena):
    """After the same extend (arena updated in place, or not built yet),
    both indexes hold the same partitions and arena and give the same
    answers; the new ids continue the row numbering."""
    db, wl, state = built
    ref = RefIndex.from_state(state)
    port = HQIIndex.from_state(state, device="cpu")
    if arena == "not built":
        ref._arena, port._arena = None, None
    n_parts = len(port.partitions)
    ids_a = ref.extend(_new_rows(db, 120, 7, RefColumn, RefDB))
    ids_b = port.extend(_new_rows(db, 120, 7))
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_array_equal(ids_b, db.n + np.arange(120))
    assert len(port.partitions) == n_parts and port.db.n == db.n + 120
    for pa, pb in zip(ref.partitions, port.partitions):
        np.testing.assert_array_equal(pa.rows, pb.rows)
        np.testing.assert_array_equal(pa.ivf.order, pb.ivf.order)
    for key, va in ref.arena.to_state().items():
        vb = port.arena.to_state()[key]
        if isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, vb)
    for batch_vec in (True, False, "auto"):
        a = ref.search(wl, nprobe=6, batch_vec=batch_vec)
        b = port.search(wl, nprobe=6, batch_vec=batch_vec)
        assert_same_results(a.scores, a.ids, b.scores, b.ids)


def test_hqi_extend_with_coarse_centroids_matches_reference():
    """The m > 0 configuration routes new rows by their coarse centroid."""
    db = small_db(n=1500, seed=5)
    wl = small_workload(db, n_queries=48)
    state = RefIndex.build(db, wl, RefConfig(m=2, n_coarse_centroids=8, **CFG)).to_state()
    ref = RefIndex.from_state(state)
    port = HQIIndex.from_state(state, device="cpu")
    ref.extend(_new_rows(db, 90, 3, RefColumn, RefDB))
    port.extend(_new_rows(db, 90, 3))
    for pa, pb in zip(ref.partitions, port.partitions):
        np.testing.assert_array_equal(pa.rows, pb.rows)
    a, b = ref.search(wl, nprobe=6), port.search(wl, nprobe=6)
    assert_same_results(a.scores, a.ids, b.scores, b.ids)


def test_arena_updated_reencodes_only_changed_partitions(monkeypatch):
    """``updated`` encodes the rows appended to the changed partitions and
    nothing else (their old rows keep their codes), and equals a full
    ``from_partitions`` rebuild."""
    from repro.core import train_pq as ref_train_pq
    from repro_torch.core.pq import PQCodebook

    db = small_db(n=1500, seed=5)
    wl = small_workload(db, n_queries=48)
    ref = RefIndex.build(db, wl, RefConfig(**CFG))
    ref.attach_pq(ref_train_pq(db.vectors, 4, metric=db.metric))
    port = HQIIndex.from_state(ref.to_state(), device="cpu")
    assert port.arena.codes is not None
    encoded = []
    real_encode = arena_mod.encode_pq_tensor

    def spy(cb, rows, device="cuda"):
        encoded.append(rows.shape[0])
        return real_encode(cb, rows, device=device)

    monkeypatch.setattr(arena_mod, "encode_pq_tensor", spy)
    new = _new_rows(db, 40, 11)
    leaves = port.tree.route_tuples(new)
    changed = sorted(set(leaves.tolist()))
    port.extend(new)
    assert 0 < len(changed) < len(port.partitions)
    assert encoded == [int((leaves == li).sum()) for li in changed]
    encoded.clear()
    full = PackedArena.from_partitions(
        [(p.rows, p.ivf) for p in port.partitions],
        pq=PQCodebook.from_state(port.pq.to_state()), device="cpu",
    )
    assert sum(encoded) == full.n
    got, want = port.arena.to_state(), full.to_state()
    for key in ("packed", "gid", "local_of", "list_start", "list_len", "list_base",
                "part_row", "codes"):
        np.testing.assert_array_equal(got[key], want[key])


def test_invalidate_caches_clears_router_cache_and_arena(built):
    db, wl, state = built
    port = HQIIndex.from_state(state, device="cpu")
    port.search(wl, nprobe=4)
    assert port.router._bitmap_cache and port._arena is not None
    n0 = port.arena.n
    port.extend(_new_rows(db, 5, 2))
    assert port.router._bitmap_cache == {}  # stale [old_n] bitmaps dropped
    assert port.arena.n == n0 + 5
    assert set(port.arena.gid.tolist()) == set(range(n0 + 5))
    for p in port.partitions:
        assert len(p.rows) == p.ivf.n
    port.router.template_bitmap(wl.templates[0])
    port.invalidate_caches()
    assert port.router._bitmap_cache == {} and port._arena is None
    a = RefIndex.from_state(port.to_state()).search(wl, nprobe=4)  # rebuilt lazily
    b = port.search(wl, nprobe=4)
    assert_same_results(a.scores, a.ids, b.scores, b.ids)
