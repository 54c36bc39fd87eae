"""The shapes the card once refused, on the CPU: k′ past the kernels'
64-entry lists, M past the staged ADC kernels' 190, attention heads past
256.

  * the engine at k = 100 (f32, both merge layouts) and at
    ``refine_factor=8`` (PQ, k′ 80, both layouts), from a reference index
    loaded through ``to_state()``, equal to ``repro``'s answers;
  * the floor passes (``fused_knn.floor_passes``) as the wrappers run them,
    each launch replaced by a pure-Python emulation of the kernel's
    admission rule (a candidate enters a pass iff it ranks strictly after
    the slot's floor, the last entry of the pass before; a floor index of -1
    admits nothing), held bit for bit against the plain versions, ties and
    short slots included, for all five scan kernels and the wide-M kernel;
  * the ADC plain versions at M 256 against ``repro.kernels.ref``, and
    attention at dh 320 against ``flash_attention_pallas`` in interpret mode;
  * the routes (``kernel_passes``, ``wide_m``, ``wide_head``) and the Python
    copies of the wide kernels' launch shapes, which
    ``tests/test_torch_cuda.py`` holds equal to the C entries on the card.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import HQIConfig as RefConfig
from repro.core import HQIIndex as RefIndex
from repro.core.plan import PlanConfig as RefPlanConfig
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.core import planner
from repro_torch.core.hqi import HQIIndex
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_knn as fk
from repro_torch.kernels import pq_scan as ps
from repro_torch.kernels import ref

from conftest import assert_same_results, small_db, small_workload

NEG_INF = ref.NEG_INF


# ------------------------------------------------------------------ engine


@pytest.mark.parametrize("layout", ["segmented", "dense"])
def test_engine_k100_matches_reference(layout):
    """k = 100 (two passes of the f32 scan on the card): the port's answers
    from the reference's index equal the reference's."""
    db = small_db(n=1500, seed=31)
    wl = small_workload(db, n_queries=24, seed=32, k=100)
    idx = RefIndex.build(db, wl, RefConfig(min_partition_size=128, max_leaves=8,
                                           plan=RefPlanConfig(merge_layout=layout)))
    port = HQIIndex.from_state(idx.to_state(), device="cpu")
    a, b = idx.search(wl, nprobe=4), port.search(wl, nprobe=4)
    assert b.ids.shape == (wl.m, 100)
    assert_same_results(a.scores, a.ids, b.scores, b.ids)


@pytest.mark.parametrize("layout", ["segmented", "dense"])
def test_engine_refine_factor_8_matches_reference(layout):
    """``refine_factor=8`` at k = 10: the ADC scan keeps k′ = 80 (two passes
    on the card) before the exact re-rank; equal to the reference."""
    db = small_db(n=1500, seed=33)
    wl = small_workload(db, n_queries=24, seed=34, k=10)
    idx = RefIndex.build(db, wl, RefConfig(min_partition_size=128, max_leaves=8, scan_mode="pq",
                                           pq_m=4, plan=RefPlanConfig(merge_layout=layout)))
    port = HQIIndex.from_state(idx.to_state(), device="cpu")
    a = idx.search(wl, nprobe=4, refine_factor=8)
    b = port.search(wl, nprobe=4, refine_factor=8)
    assert_same_results(a.scores, a.ids, b.scores, b.ids)


# ---------------------------------------------- the floor passes, emulated


def _emulated_pass(scores, valid, live, k, floor, calls):
    """One launch as the kernels run it: for each live slot (``live`` bool
    [W, TQ]) whose floor index is not -1, the valid rows that rank strictly
    after the floor under (score desc, row asc), best k first; ``(NEG_INF,
    -1)`` elsewhere, and -1 for a score in the masked band. ``calls``
    records each launch's live slots and floor."""
    W, TQ, TV = scores.shape
    calls.append((live.clone(), None if floor is None else floor[1].clone()))
    out_s = torch.full((W, TQ, k), NEG_INF, dtype=torch.float32)
    out_i = torch.full((W, TQ, k), -1, dtype=torch.int32)
    for w in range(W):
        rows = [r for r in range(TV) if valid[w, r]]
        for t in range(TQ):
            if not live[w, t] or (floor is not None and floor[1][w, t] < 0):
                continue
            cands = [(float(scores[w, t, r]), r) for r in rows]
            if floor is not None:
                fs, fi = float(floor[0][w, t]), int(floor[1][w, t])
                cands = [(s, r) for s, r in cands if s < fs or (s == fs and r > fi)]
            cands.sort(key=lambda c: (-c[0], c[1]))
            for e, (s, r) in enumerate(cands[:k]):
                out_s[w, t, e] = s
                out_i[w, t, e] = -1 if s <= NEG_INF / 2 else r
    return out_s, out_i


def _no_done_unit_read(calls):
    """A later pass reads no unit whose every slot the pass before left short."""
    for live, floor_i in calls[1:]:
        done = (floor_i < 0).all(dim=1)
        assert not live[done].any()


def _knn_case(seed, w, tq, tv, d=8):
    """f32 units with exact ties (duplicated rows) and short units (few
    valid rows), and ragged ``n_live``."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(w, tq, d)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(w, tv, d)).astype(np.float32))
    v[:, 40:80] = v[:, :40]  # every score of rows 0-39 tied once more
    v[:, 100:110] = v[:, 5:6]  # a run of ties
    valid = torch.from_numpy(rng.random((w, tv)) < 0.8)
    valid[0, 30:] = False  # short in the first pass
    valid[1, 90:] = False  # short in the second
    n_live = torch.from_numpy(rng.integers(0, tq + 1, w).astype(np.int32))
    n_live[0] = tq
    return q, v, valid, n_live


@pytest.mark.parametrize("k", [65, 80, 128, 200])
@pytest.mark.parametrize("tq", [1, 5])
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_fused_knn_floor_passes_emulated(k, tq, metric, monkeypatch):
    """Both f32 grids' passes (``fused_knn._passes``, the TQ 1 units of the
    re-rank included) equal the plain version bit for bit."""
    q, v, valid, n_live = _knn_case(k + tq, 4, tq, 260)
    scores = ref.kernel_order_scores(q, v, metric)
    calls = []

    def launch_pass(wrapper, entry, q_, v_, valid_, kp, metric_, live, floor):
        alive = torch.arange(tq)[None, :] < (live if live is not None else torch.full((4,), tq))[:, None]
        return _emulated_pass(scores, valid_, alive, kp, floor, calls)

    monkeypatch.setattr(fk, "_launch_pass", launch_pass)
    got = fk._passes(fk.fused_knn, "fused_knn_launch", q, v, valid, k, metric, n_live)
    want = fk.fused_knn_plain(q, v, valid, k=k, metric=metric, n_live=n_live)
    assert len(calls) == fk.kernel_passes(k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    _no_done_unit_read(calls)


def _adc_case(seed, w, tq, tv, m, u=6):
    """A resident table of u random rows with ties (equal rows, equal
    codes), per-slot indices with -1 padding, codes, a mask with short
    units."""
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.normal(size=(u, m, 256)).astype(np.float32))
    table[1] = table[0]
    lut_idx = torch.from_numpy(rng.integers(0, u, (w, tq)).astype(np.int32))
    lut_idx[:, -1] = -1
    codes = torch.from_numpy(rng.integers(0, 256, (w, tv, m)).astype(np.uint8))
    codes[:, 50:90] = codes[:, :40]  # tied scores
    valid = torch.from_numpy(rng.random((w, tv)) < 0.8)
    valid[0, 30:] = False
    return table, lut_idx, codes, valid


@pytest.mark.parametrize("k", [65, 130])
@pytest.mark.parametrize("m", [8, 256])
@pytest.mark.parametrize("kernel", ["units", "dense", "rows", "wide-table", "wide-expanded"])
def test_adc_floor_passes_emulated(k, m, kernel, monkeypatch):
    """The ADC kernels' passes as their wrappers run them (the units
    kernel's -1 for a slot left short, the dense kernel's ``live_after``,
    the rows kernel's one query, and ``adc_wide_m`` in both addressings)
    equal the plain versions bit for bit."""
    table, lut_idx, codes, valid = _adc_case(k + m, 3, 4, 220, m)
    calls = []
    luts = table[lut_idx.clamp(min=0).long()]  # [W, TQ, M, 256]
    scores = ref.adc_scores_ref(luts, codes)
    if kernel == "units":
        monkeypatch.setattr(ps, "_units_pass", lambda tab, idx, c, vv, kp, floor: _emulated_pass(
            scores, vv, idx >= 0, kp, floor, calls))
        got = ps._units_passes(table, lut_idx, codes, valid, k)
        want = ps.workunit_pq_scan_streamed_plain(table, lut_idx, codes, valid, k=k)
    elif kernel == "dense":
        n_live = torch.tensor([4, 2, 0], dtype=torch.int32)
        monkeypatch.setattr(ps, "_dense_pass", lambda l, c, vv, live, kp, floor: _emulated_pass(
            scores, vv, torch.arange(4)[None, :] < live[:, None], kp, floor, calls))
        got = ps._dense_passes(luts, codes, valid, n_live, k)
        want = ps.workunit_pq_scan_plain(luts, codes, valid, k=k, n_live=n_live)
    elif kernel == "rows":
        def rows_pass(lut, c, vv, kp, floor):
            one = None if floor is None else (floor[0].reshape(1, 1), floor[1].reshape(1, 1))
            s, i = _emulated_pass(scores[:1, :1], vv[None], torch.ones((1, 1), dtype=torch.bool),
                                  kp, one, calls)
            return s[0, 0], i[0, 0]
        monkeypatch.setattr(ps, "_rows_pass", rows_pass)
        got = ps._rows_passes(luts[0, 0], codes[0], valid[0], k)
        want = ps.pq_scan_plain(luts[0, 0], codes[0], valid[0], k=k)
    else:
        table_mode = kernel == "wide-table"
        n_live = None if table_mode else torch.tensor([4, 1, 3], dtype=torch.int32)

        def wide_pass(l, c, vv, kp, floor, idx=None, n_live=None):
            alive = (idx >= 0) if idx is not None else torch.arange(4)[None, :] < n_live[:, None]
            return _emulated_pass(scores, vv, alive, kp, floor, calls)

        monkeypatch.setattr(ps, "_wide_pass", wide_pass)
        if table_mode:
            got = ps.adc_wide_m(table, codes, valid, k=k, lut_idx=lut_idx)
            want = ps.workunit_pq_scan_streamed_plain(table, lut_idx, codes, valid, k=k)
        else:
            got = ps.adc_wide_m(luts, codes, valid, k=k, n_live=n_live)
            want = ps.workunit_pq_scan_plain(luts, codes, valid, k=k, n_live=n_live)
    assert len(calls) == fk.kernel_passes(k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if kernel in ("units", "dense", "wide-table"):
        _no_done_unit_read(calls)


def test_floor_passes_lay_passes_end_to_end():
    """``floor_passes`` at k ≤ 64 is one call without a floor; past it each
    pass gets the last entry of the one before and the lists concatenate
    along k, in order."""
    seen = []

    def run(kp, floor):
        seen.append((kp, None if floor is None else (float(floor[0][0]), int(floor[1][0]))))
        base = 100.0 - 64 * (len(seen) - 1)
        s = torch.tensor([[base - e for e in range(kp)]], dtype=torch.float32)
        return s, torch.arange(kp, dtype=torch.int32)[None] + 64 * (len(seen) - 1)

    s, i = fk.floor_passes(10, run)
    assert seen == [(10, None)] and s.shape == (1, 10)
    seen.clear()
    s, i = fk.floor_passes(150, run)
    assert seen == [(64, None), (64, (37.0, 63)), (22, (-27.0, 127))]
    assert torch.equal(i[0], torch.arange(150, dtype=torch.int32))
    assert torch.equal(fk.live_after(torch.tensor([[3, -1, 7, -1], [-1, -1, -1, -1]])),
                       torch.tensor([3, 0], dtype=torch.int32))


# ---------------------------------------------------- plain versions vs repro


@pytest.mark.parametrize("w,tq,nv,k", [(2, 3, 60, 7), (1, 2, 90, 70)])
def test_adc_plain_at_m256_matches_reference(w, tq, nv, k):
    """The ADC plain versions (what the wide-M kernel equals bit for bit) at
    M 256 against ``repro.kernels.ref``: scores within 1e-4, ids equal."""
    rng = np.random.default_rng(nv)
    luts = rng.normal(size=(w, tq, 256, 256)).astype(np.float32)
    codes = rng.integers(0, 256, (w, nv, 256)).astype(np.uint8)
    valid = rng.random((w, nv)) < 0.9
    rs, ri = jref.workunit_pq_topk_ref(jnp.asarray(luts), jnp.asarray(codes), jnp.asarray(valid), k)
    s, i = ps.workunit_pq_scan(*(torch.from_numpy(a) for a in (luts, codes, valid)), k=k)
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=1e-4, atol=1e-4)
    assert np.array_equal(i.numpy(), np.asarray(ri))
    s1, i1 = ps.pq_scan(*(torch.from_numpy(a) for a in (luts[0, 0], codes[0], valid[0])), k=k)
    assert torch.equal(s1, s[0, 0]) and torch.equal(i1, i[0, 0])


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 7), (False, 0)])
def test_attention_at_dh320_matches_pallas(causal, window):
    """Attention at dh 320 (the wide-dh kernel's width on the card): the
    wrapper on CPU tensors against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(320 + window)
    q = rng.normal(size=(1, 24, 2, 320)).astype(np.float32)
    k, v = (rng.normal(size=(1, 24, 1, 320)).astype(np.float32) for _ in range(2))
    got = fa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal, window=window)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                                  window=window, bq=8, bk=8, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3, atol=2e-3)


# ------------------------------------------------------- routes and shapes


@pytest.mark.parametrize("k,m,dh", [(65, 191, 257), (80, 256, 288), (128, 384, 512), (400, 768, 2100)])
def test_no_limit_left(k, m, dh):
    """No shape the reference answers is refused: k′ past 64 takes passes,
    M past ``MAX_M`` the wide-M kernel, dh past 256 the wide-dh kernel, and
    the engine checks nothing before launch."""
    assert fk.kernel_passes(k) == -(-k // 64) > 1
    assert ps.wide_m(m) and not ps.wide_m(ps.MAX_M)
    assert fa.wide_head(dh) and not fa.wide_head(fa.MAX_HEAD_DIM)
    assert not [n for n in dir(planner) if "limits" in n]
    assert not [n for mod in (fk, ps, fa) for n in dir(mod) if n.startswith("check_") and "limit" in n]


@pytest.mark.parametrize("dh", [257, 288, 320, 512, 640, 1024, 1025, 2048, 2100, 4096, 16384])
@pytest.mark.parametrize("elem", [2, 4])
def test_wide_attention_launch_shape(dh, elem):
    """The wide kernels' launch (a Python copy of
    ``flash_attention_wide_shape``). bf16 up to 512: the wgmma kernel at DH
    384 or 512, a block per (128 query rows, head, batch, column slice of
    192 or 256), 384 threads, 32-key K/V tiles. Otherwise the sliced CUDA-
    core kernel: 256 threads and 64 query rows a block, 64-key tiles, dh in
    the fewest blocks of at most 512 columns (two halves, a multiple of 32
    each), grid y = heads × blocks under 65536. Both within a block's 227
    KiB; every column covered."""
    gx, gy, gz, threads, smem, keys, dv = fa.wide_launch_shape(2, 100, 32, dh, elem)
    assert smem <= 227 * 1024 and dv % 32 == 0 and dv <= 256
    if elem == 2 and dh <= fa.WIDE_WGMMA_MAX:
        slices = gx // (32 * 2)
        assert (gy, gz, threads, keys) == (1, 1, 384, 32) and dv in (192, 256)
        assert gx == 1 * 32 * 2 * slices and (slices - 1) * dv < dh <= slices * dv
        return
    blocks = gy // 32
    assert (gx, gz, threads, keys) == (2, 2, 256, 64) and gy == 32 * blocks < 65536
    assert (blocks - 1) * 2 * dv < dh <= blocks * 2 * dv and blocks == -(-dh // 512) and dv >= 160


@pytest.mark.parametrize("w,tq,tv", [(1, 1, 20_000), (3, 5, 700), (4096, 64, 64), (256, 64, 256),
                                     (6, 8, 3000)])
def test_wide_m_launch_shape(w, tq, tv):
    """``adc_wide_m_kernel``'s launch (a Python copy of ``adc_wide_m_shape``):
    256 threads; an item is P slots of the sorted order with g warps a slot
    (units: P·g = 8, g·256 rows covering TV where 8 warps do) or one slot
    over 8 warps (dense); two blocks an SM walk the items (no more blocks
    than items); two 48-subspace slices and the candidate buffers, two
    blocks an SM."""
    for dense in (False, True):
        blocks, threads, smem, p, g, ms = ps.wide_m_launch_shape(w, tq, tv, dense, sms=132)
        items = -(-w * tq // p)
        assert threads == 256 and ms == 48 and p * g == 8 and 2 * smem <= 228 * 1024
        assert blocks == min(items, 2 * 132)
        if dense:
            assert (p, g) == (1, 8)
        else:
            assert g * 256 >= tv or g == 8
            assert g == 1 or (g // 2) * 256 < tv
