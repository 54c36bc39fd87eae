"""The port's engine against the reference, on the CPU.

Parity loads a reference index through ``to_state()`` into
``repro_torch.core.hqi.HQIIndex.from_state(state, device="cpu")``, so the
comparison is of search, not of k-means drift; an independent port build is
held to the reference build's recall instead.
"""
import copy
import dataclasses

import numpy as np
import pytest

from repro.core import HQIConfig as RefConfig
from repro.core import HQIIndex as RefIndex
from repro.core import exhaustive_search as ref_exhaustive_search
from repro.core import recall_at_k
from repro.core.workload import kg_style
from repro.kernels import ops as ref_ops
from repro_torch.core import HQIConfig, PlanConfig
from repro_torch.core.baselines import exhaustive_search
from repro_torch.core.hqi import HQIIndex
from repro_torch.kernels import ops

from conftest import assert_same_results, small_db, small_workload

CFG = dict(min_partition_size=128, max_leaves=32)


@pytest.fixture(scope="module", params=["ip", "l2"])
def built(request):
    db = small_db(metric=request.param)
    wl = small_workload(db)
    ref = RefIndex.build(db, wl, RefConfig(**CFG))
    return db, wl, ref, ref.to_state()


def _with_layout(state, layout):
    state = copy.copy(state)
    state["cfg"] = dict(state["cfg"], plan=dict(state["cfg"]["plan"], merge_layout=layout))
    return state


@pytest.mark.parametrize("layout", ["segmented", "dense"])
@pytest.mark.parametrize("nprobe", ["int", "dict"])
@pytest.mark.parametrize("batch_vec", [True, False, "auto"])
def test_search_matches_reference(built, layout, nprobe, batch_vec):
    db, wl, _, state = built
    state = _with_layout(state, layout)
    ref = RefIndex.from_state(state)
    port = HQIIndex.from_state(state, device="cpu")
    np_ = 6 if nprobe == "int" else {t: 2 + 2 * (t % 3) for t in range(len(wl.templates))}
    ref_ops.reset_dispatch_stats()
    ops.reset_dispatch_stats()
    a = ref.search(wl, nprobe=np_, batch_vec=batch_vec)
    b = port.search(wl, nprobe=np_, batch_vec=batch_vec)
    assert_same_results(a.scores, a.ids, b.scores, b.ids)
    ra, rb = ref_ops.dispatch_stats(), ops.dispatch_stats()
    assert (ra.knn_calls, ra.merge_calls, ra.shapes) == (rb.knn_calls, rb.merge_calls, rb.shapes)
    assert (a.tuples_scanned, a.bytes_scanned, a.peak_candidate_bytes) == (
        b.tuples_scanned, b.bytes_scanned, b.peak_candidate_bytes)
    assert a.part_probes == b.part_probes


@pytest.mark.parametrize("batch_vec", [True, False, "auto"])
def test_live_mask_matches_reference(built, batch_vec):
    db, wl, ref, state = built
    port = HQIIndex.from_state(state, device="cpu")
    live = np.random.default_rng(7).random(db.n) < 0.6
    a = ref.search(wl, nprobe=6, batch_vec=batch_vec, live_mask=live)
    b = port.search(wl, nprobe=6, batch_vec=batch_vec, live_mask=live)
    assert_same_results(a.scores, a.ids, b.scores, b.ids)
    assert live[b.ids[b.ids >= 0]].all()


def test_search_online_and_empty_template(built):
    from repro_torch.core.predicates import Between, make_filter
    from repro_torch.core.types import Workload

    db, wl, ref, state = built
    port = HQIIndex.from_state(state, device="cpu")
    a = ref.search_online(wl, nprobe=4)
    b = port.search_online(wl, nprobe=4)
    assert_same_results(a.scores, a.ids, b.scores, b.ids)
    empty = Workload(vectors=wl.vectors[:5], templates=[make_filter(Between("A", 5.0, 6.0))],
                     template_of=np.zeros(5, dtype=np.int32), k=4)
    r = port.search(empty, nprobe=4)
    assert (r.ids == -1).all() and np.isneginf(r.scores).all()


def test_kg_style_and_centroid_mode_match_reference():
    """A KG-shaped index, in the m > 0 (centroid-routing) mode."""
    kg = kg_style(n=3000, d=16, queries_per_split=300, seed=0)
    cfg = dict(m=2, n_coarse_centroids=8, min_partition_size=128, max_leaves=16)
    ref = RefIndex.build(kg.db, kg.splits[0], RefConfig(**cfg))
    port = HQIIndex.from_state(ref.to_state(), device="cpu")
    for wl in kg.splits[1:3]:
        a = ref.search(wl, nprobe=4)
        b = port.search(wl, nprobe=4)
        assert_same_results(a.scores, a.ids, b.scores, b.ids)


def test_segmented_and_dense_bit_identical():
    """Within the port the two merge layouts agree exactly, ties included."""
    db = small_db(n=900, seed=3)
    db.vectors[100:120] = db.vectors[0]  # duplicated rows: exact score ties
    wl = small_workload(db, n_queries=40)
    out = []
    for layout in ("segmented", "dense"):
        cfg = HQIConfig(**CFG, plan=PlanConfig(tq_unit=8, min_list_pad=8, merge_layout=layout))
        idx = HQIIndex.build(db, wl, cfg, device="cpu")
        r = idx.search(wl, nprobe=4, batch_vec="auto")
        out.append((r.scores, r.ids))
    assert np.array_equal(out[0][0], out[1][0])
    assert np.array_equal(out[0][1], out[1][1])


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_independent_build_recall(metric):
    """A port-built index reaches the reference build's recall (−0.02)."""
    db = small_db(metric=metric, seed=5)
    wl = small_workload(db, seed=6)
    truth = ref_exhaustive_search(db, wl)
    ref = RefIndex.build(db, wl, RefConfig(**CFG))
    port = HQIIndex.build(db, wl, HQIConfig(**CFG), device="cpu")
    r_ref = recall_at_k(ref.search(wl, nprobe=4), truth)
    r_port = recall_at_k(port.search(wl, nprobe=4), truth)
    assert r_port >= r_ref - 0.02, (r_port, r_ref)


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_exhaustive_search_matches_reference(metric):
    db = small_db(metric=metric, seed=8)
    wl = small_workload(db, seed=9)
    a = ref_exhaustive_search(db, wl)
    b = exhaustive_search(db, wl, device="cpu", chunk=16)
    assert_same_results(a.scores, a.ids, b.scores, b.ids)
    assert a.tuples_scanned == b.tuples_scanned


def test_state_round_trip_both_ways(built):
    """The port's to_state() loads in the port and in the reference alike."""
    db, wl, ref, state = built
    port = HQIIndex.from_state(state, device="cpu")
    back = port.to_state()
    again = HQIIndex.from_state(back, device="cpu")
    ref2 = RefIndex.from_state(back)
    a = port.search(wl, nprobe=5)
    for other in (again, ref2):
        b = other.search(wl, nprobe=5)
        assert_same_results(a.scores, a.ids, b.scores, b.ids)


def test_unported_paths_raise(built):
    """The sharded engine (ROADMAP.md §1, sharded engine) is the one path left
    unported; a compressed search without a codebook is refused by name."""
    db, wl, _, state = built
    port = HQIIndex.from_state(state, device="cpu")
    with pytest.raises(ValueError, match="attach_pq"):
        port.search(wl, nprobe=4, scan_mode="pq")
    with pytest.raises(NotImplementedError, match="sharded engine"):
        HQIIndex.build(db, wl, HQIConfig(**CFG, mesh=object()), device="cpu")
    with pytest.raises(ValueError, match="pq_m"):
        HQIIndex.build(db, wl, HQIConfig(**CFG, scan_mode="pq", pq_m=5), device="cpu")
    assert dataclasses.asdict(port.cfg.plan) == state["cfg"]["plan"]
