"""The port's compressed (PQ) path against the reference, on the CPU.

On CPU tensors the ADC wrappers of ``repro_torch.kernels.pq_scan`` run their
plain versions, so these tests hold those versions, the dispatch layer, the
PQ module, the compressed engine and the baselines against ``repro`` on
inputs made with seeded numpy. The CUDA kernel is held against the same
plain versions on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.

Tolerances: ADC scores are sums of M fp32 lookups whose order XLA chooses on
the reference side (the port sums m = 0 … M-1), and engine scores are fp32
products taken by another BLAS, so scores are held within rtol/atol 1e-4
(``assert_same_results``) and ids equal wherever scores are untied. Two
runs of the port on the same inputs agree exactly.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import HQIConfig as RefConfig
from repro.core import HQIIndex as RefIndex
from repro.core import PostFilterIndex as RefPostFilter
from repro.core import PreFilterIndex as RefPreFilter
from repro.core import RangeIndex as RefRange
from repro.core import recall_at_k
from repro.core.ivf import IVFIndex as RefIVF
from repro.core.planner import batch_search_ivf as ref_batch_search_ivf
from repro.core.pq import PQIndex as RefPQIndex
from repro.core.pq import adc_tables as ref_adc_tables
from repro.core.pq import decode_pq as ref_decode_pq
from repro.core.pq import encode_pq as ref_encode_pq
from repro.core.pq import train_pq as ref_train_pq
from repro.core.workload import kg_style
from repro.kernels import ops as ref_ops
from repro.kernels import pq_scan as pallas
from repro.kernels import ref as jref
from repro_torch.core import HQIConfig, HQIIndex, PlanConfig
from repro_torch.core.baselines import PostFilterIndex, PreFilterIndex, RangeIndex
from repro_torch.core.ivf import IVFIndex
from repro_torch.core.planner import batch_search_ivf
from repro_torch.core.pq import (
    PQCodebook,
    PQIndex,
    adc_scan_ref,
    adc_tables,
    decode_pq,
    encode_pq,
    train_pq,
)
from repro_torch.kernels import ops, ref
from repro_torch.kernels.fused_knn import MAX_K, SMEM_OPTIN_BYTES
from repro_torch.core.ivf import ScanStats
from repro_torch.core.plan import build_plan
from repro_torch.core.planner import pq_bucket_operands, resident_luts
from repro_torch.kernels.pq_scan import (
    NBOOK,
    MAX_M,
    WHOLE_ROW_MAX_M,
    lut_stationary_slice,
    lut_stationary_smem_bytes,
    pq_scan,
    pq_scan_plain,
    slot_order,
    staged_lut_rows,
    units_split,
    workunit_pq_scan,
    workunit_pq_scan_plain,
    workunit_pq_scan_streamed,
    wide_m,
    workunit_pq_scan_streamed_plain,
)

from conftest import assert_same_results, small_db, small_workload

CFG = dict(min_partition_size=128, max_leaves=32)
TOL = 1e-4


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _adc_case(seed, w, tq, nv, m, density=0.7):
    """LUTs from a trained codebook (realistic score spreads), codes of
    random database rows, a random mask."""
    rng = np.random.default_rng(seed)
    d = m * 4
    vecs = rng.normal(size=(max(nv, 300), d)).astype(np.float32)
    cb = PQCodebook.from_state(ref_train_pq(vecs, m, iters=2, seed=seed).to_state())
    luts = adc_tables(cb, rng.normal(size=(w * tq, d)).astype(np.float32)).reshape(w, tq, m, 256)
    codes = encode_pq(cb, vecs, device="cpu")[rng.integers(0, len(vecs), (w, nv))]
    valid = rng.random((w, nv)) < density
    return luts, codes, valid


def _assert_ids_untied(s, i, rs, ri, tol=TOL):
    """Same ids wherever the reference score is untied (the last slot may tie
    with the first row left out); the same absent slots."""
    assert np.array_equal(i < 0, ri < 0)
    rs = rs.astype(np.float64)
    gap = tol * (1.0 + np.abs(rs))
    near = np.abs(rs[..., 1:] - rs[..., :-1]) <= gap[..., 1:]
    tied = np.zeros(rs.shape, bool)
    tied[..., 1:] |= near
    tied[..., :-1] |= near
    tied[..., -1] = True
    assert np.array_equal(i[~tied], ri[~tied])


# ------------------------------------------------------------------ kernels


@pytest.mark.parametrize(
    "w,tq,nv,m,k",
    [(3, 5, 100, 4, 6), (1, 8, 700, 8, 10), (4, 2, 30, 4, 3), (2, 7, 333, 16, 12), (2, 64, 37, 8, 37)],
)
def test_adc_plain_matches_reference(w, tq, nv, m, k):
    """The plain ADC versions (CPU path of both work-unit wrappers) against
    ``repro.kernels.ref.workunit_pq_topk_ref`` on the reference's sweep, with
    M in {4, 8, 16}, ragged TV and k = TV."""
    luts, codes, valid = _adc_case(w * 100 + m, w, tq, nv, m)
    rs, ri = jref.workunit_pq_topk_ref(jnp.asarray(luts), jnp.asarray(codes), jnp.asarray(valid), k)
    rs, ri = np.asarray(rs), np.asarray(ri)
    s, i = workunit_pq_scan(_t(luts), _t(codes), _t(valid), k=k)
    np.testing.assert_allclose(s.numpy(), rs, rtol=TOL, atol=TOL)
    _assert_ids_untied(s.numpy(), i.numpy(), rs, ri)
    for w_ in range(w):  # per unit, the one-query oracles agree too
        a = adc_scan_ref(_t(luts[w_]), _t(codes[w_]), _t(valid[w_]), k)
        b = jref.adc_topk_ref(jnp.asarray(luts[w_]), jnp.asarray(codes[w_]), jnp.asarray(valid[w_]), k)
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b[0]), rtol=TOL, atol=TOL)
        _assert_ids_untied(a[0].numpy(), a[1].numpy(), np.asarray(b[0]), np.asarray(b[1]))


@pytest.mark.parametrize("grid", ["workunit_pq_scan", "workunit_pq_scan_streamed", "pq_scan"])
def test_adc_all_invalid_and_k_above_valid(grid):
    luts, codes, valid = _adc_case(3, 2, 3, 200, 8)
    table = luts.reshape(6, 8, 256)
    lut_idx = np.arange(6, dtype=np.int32).reshape(2, 3)

    def run(valid, k):
        if grid == "workunit_pq_scan":
            return workunit_pq_scan(_t(luts), _t(codes), _t(valid), k=k)
        if grid == "workunit_pq_scan_streamed":
            return workunit_pq_scan_streamed(_t(table), _t(lut_idx), _t(codes), _t(valid), k=k)
        s, i = pq_scan(_t(table[0]), _t(codes[0]), _t(valid[0]), k=k)
        return s[None, None], i[None, None]

    s, i = run(np.zeros_like(valid), 3)
    assert (i == -1).all() and (s == np.float32(ref.NEG_INF)).all()
    few = np.zeros_like(valid)
    few[:, [10, 150]] = True
    s, i = run(few, 5)
    assert (i[..., 2:] == -1).all() and (s[..., 2:] == np.float32(ref.NEG_INF)).all()
    assert all(set(row[:2].tolist()) == {10, 150} for row in i.reshape(-1, 5).numpy())


def test_adc_matches_pallas_interpret():
    """The port against the three Pallas kernels themselves (interpret mode),
    on tiny shapes with more valid rows than k (away from the sentinel leak
    of the next test)."""
    luts, codes, valid = _adc_case(7, 2, 3, 300, 4)
    k = 5
    table = luts.reshape(6, 4, 256)
    lut_idx = np.array([[4, 0, 2], [5, 5, 1]], dtype=np.int32)
    got = {
        "workunit_pq_scan": workunit_pq_scan(_t(luts), _t(codes), _t(valid), k=k),
        "workunit_pq_scan_streamed": workunit_pq_scan_streamed(
            _t(table), _t(lut_idx), _t(codes), _t(valid), k=k),
    }
    want = {
        "workunit_pq_scan": pallas.workunit_pq_scan(
            jnp.asarray(luts), jnp.asarray(codes), jnp.asarray(valid), k=k, tv=128, interpret=True),
        "workunit_pq_scan_streamed": pallas.workunit_pq_scan_streamed(
            jnp.asarray(table), jnp.asarray(lut_idx), jnp.asarray(codes), jnp.asarray(valid),
            k=k, tv=128, interpret=True),
    }
    for name in got:
        ws, wi = np.asarray(want[name][0]), np.asarray(want[name][1])
        np.testing.assert_allclose(got[name][0].numpy(), ws, rtol=TOL, atol=TOL)
        _assert_ids_untied(got[name][0].numpy(), got[name][1].numpy(), ws, wi)
    for r in range(2):
        s, i = pq_scan(_t(table[r]), _t(codes[r]), _t(valid[r]), k=k)
        ps, pi = pallas.pq_scan(jnp.asarray(table[r]), jnp.asarray(codes[r]), jnp.asarray(valid[r]),
                                k=k, tv=128, interpret=True)
        np.testing.assert_allclose(s.numpy(), np.asarray(ps), rtol=TOL, atol=TOL)
        _assert_ids_untied(s.numpy()[None], i.numpy()[None], np.asarray(ps)[None], np.asarray(pi)[None])


def test_adc_unfilled_slots_are_absent_unlike_pallas():
    """2 valid rows of 1024, k=4: the port follows ``adc_topk_ref``
    ([700, 3, -1, -1] here); the Pallas ADC kernels share ``_merge_topk``'s
    sentinel leak (ROADMAP.md §3) and return a real id in the unfilled slots
    ([700, 3, 3, 3]), so they are compared on the filled slots only."""
    rng = np.random.default_rng(5)
    lut = rng.normal(size=(4, 256)).astype(np.float32)
    codes = rng.integers(0, 256, size=(1024, 4), dtype=np.uint8)
    valid = np.zeros(1024, bool)
    valid[[3, 700]] = True
    s, i = pq_scan(_t(lut), _t(codes), _t(valid), k=4)
    assert i.tolist() == [700, 3, -1, -1]
    assert (s[2:] == np.float32(ref.NEG_INF)).all()
    s, i = workunit_pq_scan_streamed(_t(lut[None]), torch.zeros((1, 1), dtype=torch.int32),
                                     _t(codes[None]), _t(valid[None]), k=4)
    assert i.tolist() == [[[700, 3, -1, -1]]]
    ri = jref.adc_topk_ref(jnp.asarray(lut[None]), jnp.asarray(codes), jnp.asarray(valid), 4)[1]
    assert np.asarray(ri).tolist() == [[700, 3, -1, -1]]
    _, pi = pallas.pq_scan(jnp.asarray(lut), jnp.asarray(codes), jnp.asarray(valid), k=4,
                           tv=512, interpret=True)
    assert np.asarray(pi)[:2].tolist() == [700, 3]  # filled slots agree
    assert np.asarray(pi)[2:].tolist() != [-1, -1]  # the leak, as recorded


def test_resident_dispatch_equals_expanded():
    """``workunit_pq_topk_resident`` is ``workunit_pq_topk`` over
    ``table[lut_idx]``, bit for bit; the dispatches are recorded under the
    reference's shape tags, and only the expanded one counts as such."""
    luts, codes, valid = _adc_case(11, 3, 6, 90, 8)
    table = luts.reshape(18, 8, 256)
    rng = np.random.default_rng(0)
    lut_idx = rng.integers(0, 18, size=(3, 6)).astype(np.int32)
    lut_idx[2, 4:] = 0  # padding slots read row 0
    ops.reset_dispatch_stats()
    ref_ops.reset_dispatch_stats()
    a = ops.workunit_pq_topk_resident(_t(table), _t(lut_idx), _t(codes), _t(valid), 7)
    b = ops.workunit_pq_topk(_t(table[lut_idx]), _t(codes), _t(valid), 7)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    ref_ops.workunit_pq_topk_resident(jnp.asarray(table), jnp.asarray(lut_idx), jnp.asarray(codes),
                                      jnp.asarray(valid), 7, use_pallas=False)
    ref_ops.workunit_pq_topk(jnp.asarray(table[lut_idx]), jnp.asarray(codes), jnp.asarray(valid), 7,
                             use_pallas=False)
    assert ops.dispatch_stats().shapes == ref_ops.dispatch_stats().shapes
    assert ops.dispatch_stats().knn_calls == 2
    assert ops.dispatch_stats().lut_expand_bytes == 0  # recorded by the engine, not here


def test_plain_call_counters():
    luts, codes, valid = _adc_case(1, 1, 2, 40, 4)
    table = luts.reshape(2, 4, 256)
    before = (workunit_pq_scan_plain.calls, workunit_pq_scan_streamed_plain.calls, pq_scan_plain.calls)
    workunit_pq_scan(_t(luts), _t(codes), _t(valid), k=3)
    workunit_pq_scan_streamed(_t(table), torch.zeros((1, 2), dtype=torch.int32), _t(codes), _t(valid), k=3)
    pq_scan(_t(table[0]), _t(codes[0]), _t(valid[0]), k=3)
    after = (workunit_pq_scan_plain.calls, workunit_pq_scan_streamed_plain.calls, pq_scan_plain.calls)
    assert [b - a for a, b in zip(before, after)] == [1, 1, 1]
    assert workunit_pq_scan.launches == workunit_pq_scan_streamed.launches == pq_scan.launches == 0


def test_wrappers_reject_bad_inputs():
    luts, codes, valid = _adc_case(2, 1, 2, 40, 4)
    with pytest.raises(TypeError, match="uint8"):
        workunit_pq_scan(_t(luts), _t(codes.astype(np.int32)), _t(valid), k=3)
    with pytest.raises(ValueError, match="shape mismatch"):
        workunit_pq_scan(_t(luts), _t(codes[..., :3]), _t(valid), k=3)
    with pytest.raises(ValueError, match="k=41"):
        workunit_pq_scan(_t(luts), _t(codes), _t(valid), k=41)
    with pytest.raises(TypeError, match="int32"):
        workunit_pq_scan_streamed(_t(luts[0]), torch.zeros((1, 2), dtype=torch.int64),
                                  _t(codes), _t(valid), k=3)
    with pytest.raises(TypeError, match="float32"):
        pq_scan(_t(luts[0, 0]).double(), _t(codes[0]), _t(valid[0]), k=3)


@pytest.mark.parametrize(
    "k,m,fits",
    [(40, 8, True), (MAX_K, 16, True), (MAX_K + 1, 8, True), (80, 8, True),
     (10, MAX_M, True), (10, MAX_M + 1, False), (10, 181, True)],
)
def test_pq_kernel_limits(k, m, fits):
    """The dense-layout ADC kernel takes every k (past ``MAX_K`` in
    passes) and every M whose LUT row and ring fit shared memory (``fits``:
    up to ``MAX_M``); past it ``wide_m`` sends the shape to
    ``adc_wide_m_kernel``, whose plain version is the same."""
    assert wide_m(m) != fits
    rng = np.random.default_rng(k + m)
    lut = torch.from_numpy(rng.normal(size=(1, 2, m, NBOOK)).astype(np.float32))
    codes = torch.from_numpy(rng.integers(0, NBOOK, size=(1, k + 3, m)).astype(np.uint8))
    s, i = workunit_pq_scan(lut, codes, torch.ones((1, k + 3), dtype=torch.bool), k=k)
    assert s.shape == i.shape == (1, 2, k)


@pytest.mark.parametrize(
    "k,m,fits",
    [(40, 8, True), (MAX_K, 16, True), (MAX_K + 1, 8, True), (10, MAX_M, True),
     (10, MAX_M + 1, False)],
)
def test_lut_stationary_limits(k, m, fits):
    """The LUT-stationary kernels take every k (past ``MAX_K`` in passes)
    and M up to the dense layout's kernel's ``MAX_M`` (past
    ``WHOLE_ROW_MAX_M`` the LUT row passes in slices); past it they hand
    the shape to ``adc_wide_m_kernel`` (``wide_m``)."""
    assert wide_m(m) != fits
    assert not fits or lut_stationary_slice(m) >= 8


@pytest.mark.parametrize("m", [8, 96, WHOLE_ROW_MAX_M, WHOLE_ROW_MAX_M + 1, 128, 181, MAX_M])
def test_lut_row_slices_keep_the_sum(m):
    """Past ``WHOLE_ROW_MAX_M`` (109) the LUT-stationary kernels stage the
    row in slices of ``lut_stationary_slice(m)`` subspaces, a multiple of 8
    that fits shared memory beside the rings; a row's sum carried from one
    slice to the next in the order m = 0 … M-1 (the kernels' ``sliced_row``)
    equals ``adc_scores_ref`` bit for bit."""
    ms = lut_stationary_slice(m)
    assert lut_stationary_smem_bytes(m, ms) <= SMEM_OPTIN_BYTES
    if m <= WHOLE_ROW_MAX_M:
        assert ms == m
    else:
        assert 8 <= ms < m and ms % 8 == 0
        assert lut_stationary_smem_bytes(m, ms + 8) > SMEM_OPTIN_BYTES
    rng = np.random.default_rng(m)
    lut = torch.from_numpy(rng.normal(size=(1, m, NBOOK)).astype(np.float32))
    codes = torch.from_numpy(rng.integers(0, NBOOK, size=(300, m)).astype(np.uint8))
    acc = torch.zeros(300, dtype=torch.float32)
    for m0 in range(0, m, ms):  # one slice staged, every row's sum carried on
        for j in range(m0, min(m, m0 + ms)):
            acc = acc + lut[0, j][codes[:, j].long()]
    assert torch.equal(acc, ref.adc_scores_ref(lut, codes)[0])


# ------------------------------------------------- the -1 slot and the work list


def _resident_case(seed, w, tq, nv, m, u):
    """A resident table of u rows (from a trained codebook), per-slot row
    indices, codes and a mask."""
    luts, codes, valid = _adc_case(seed, 1, u, nv, m)
    table = luts[0]
    rng = np.random.default_rng(seed + 1)
    lut_idx = rng.integers(0, u, size=(w, tq)).astype(np.int32)
    codes = codes[0][rng.integers(0, nv, size=(w, nv))]
    valid = rng.random((w, nv)) < 0.7
    return table, lut_idx, codes, valid


def test_padding_slots_are_absent_and_never_read():
    """A -1 slot beside real ones: (NEG_INF, -1), whatever the table holds
    (NaN rows would poison any read); the real slots equal ``repro``'s
    resident reference on the same inputs (the reference reads row 0 for
    its padding, whose output the engines drop)."""
    table, lut_idx, codes, valid = _resident_case(21, 4, 6, 120, 8, 9)
    lut_idx[1, 2:] = -1
    lut_idx[3, 0] = -1
    k = 9
    poisoned = table.copy()
    poisoned[0] = np.nan  # a -1 that wrapped or read row 0 would show
    real = lut_idx >= 0
    lut_idx[real & (lut_idx == 0)] = 1
    s, i = workunit_pq_scan_streamed(_t(poisoned), _t(lut_idx), _t(codes), _t(valid), k=k)
    assert (i[~_t(real)] == -1).all() and (s[~_t(real)] == np.float32(ref.NEG_INF)).all()
    assert torch.isfinite(s).all()
    rs, ri = ref_ops.workunit_pq_topk_resident(jnp.asarray(table), jnp.asarray(np.maximum(lut_idx, 0)),
                                               jnp.asarray(codes), jnp.asarray(valid), k, use_pallas=False)
    rs, ri = np.asarray(rs)[real], np.asarray(ri)[real]
    np.testing.assert_allclose(s.numpy()[real], rs, rtol=TOL, atol=TOL)
    _assert_ids_untied(s.numpy()[real], i.numpy()[real], rs, ri)
    # and bit for bit the expanded plain version on the real slots
    e = workunit_pq_scan(_t(table[np.maximum(lut_idx, 0)]), _t(codes), _t(valid), k=k)
    assert torch.equal(s[_t(real)], e[0][_t(real)]) and torch.equal(i[_t(real)], e[1][_t(real)])


@pytest.mark.parametrize("bad", [-2, -9, 9, 100])
def test_out_of_range_rows_raise_without_wrapping(bad):
    """Only -1 marks a slot with no query: any other index outside [0, U)
    raises in the plain version (torch indexing would have wrapped -2 … -U
    to a real row); the kernel clamps instead, as documented."""
    table, lut_idx, codes, valid = _resident_case(22, 2, 3, 50, 4, 9)
    lut_idx[1, 1] = bad
    with pytest.raises(IndexError, match=f"lut_idx {bad} outside"):
        workunit_pq_scan_streamed(_t(table), _t(lut_idx), _t(codes), _t(valid), k=3)
    with pytest.raises(IndexError):
        ref.workunit_pq_topk_resident_ref(_t(table), _t(lut_idx), _t(codes), _t(valid), 3)


@pytest.mark.parametrize("case", ["random", "one_row", "all_padding", "ragged"])
def test_slot_order(case):
    """The work list: every slot exactly once, grouped by row in ascending
    order, stable within a row, the -1 slots one run ahead of the rest."""
    rng = np.random.default_rng(23)
    w, tq = (7, 9) if case == "ragged" else (8, 16)
    lut_idx = rng.integers(-1, 5, size=(w, tq)).astype(np.int32)
    if case == "one_row":
        lut_idx[:] = 3
    elif case == "all_padding":
        lut_idx[:] = -1
    rows, order = slot_order(_t(lut_idx))
    assert rows.dtype == torch.int32 and order.dtype == torch.int64
    flat = lut_idx.reshape(-1)
    assert sorted(order.tolist()) == list(range(w * tq))  # every slot once
    assert np.array_equal(rows.numpy(), flat[order.numpy()])
    assert (np.diff(rows.numpy()) >= 0).all()  # grouped, rows ascending
    for r in np.unique(flat):  # stable within each row
        slots = order.numpy()[rows.numpy() == r]
        assert (np.diff(slots) > 0).all()
    npad = int((flat == -1).sum())
    assert (rows.numpy()[:npad] == -1).all() and (rows.numpy()[npad:] >= 0).all()


def _ranks_before(a, b):
    return a[0] > b[0] or (a[0] == b[0] and a[1] < b[1])


class _WarpSelect:
    """A warp's list as the kernel keeps it: candidates that rank above the
    k-th entry are buffered and merged 32 at a time."""

    def __init__(self, k):
        self.k, self.top, self.buf = k, [], []

    def offer(self, cands):  # up to 32 (score, row) pairs; None where a lane has none
        live = [c for c in cands if c is not None]
        kth = self.top[self.k - 1] if len(self.top) >= self.k else None
        passed = [c for c in live if kth is None or _ranks_before(c, kth)]
        self.buf += passed
        if len(self.buf) >= 32:
            self._merge(self.buf[:32])
            self.buf = self.buf[32:]
        return len(passed) == len(live)

    def flush(self):
        if self.buf:
            self._merge(self.buf)
            self.buf = []

    def _merge(self, cands):
        self.top = sorted(self.top + cands, key=lambda c: (-c[0], c[1]))[:self.k]


def _units_kernel_emulation(table, lut_idx, codes, valid, *, k, p, g):
    """The units kernel's decomposition in plain Python over torch's fp32
    sums: the slot order, ranges of ``p`` slots, one LUT row staged per run,
    each slot's 32-row chunks split into ``g`` pieces (1 or 8); a piece of at most two
    chunks is sorted at once, a longer one offered chunk by chunk (filtered
    against the k-th entry, buffered, merged 32 at a time); the pieces'
    lists fold into the first (sorted lists offered up to their first
    rejected chunk). Returns what the kernel writes."""
    W, TQ = lut_idx.shape
    TV, M = codes.shape[1], codes.shape[2]
    nch = -(-TV // 32)
    rows, order = slot_order(lut_idx)
    out_s = torch.full((W * TQ, k), ref.NEG_INF, dtype=torch.float32)
    out_i = torch.full((W * TQ, k), -1, dtype=torch.int32)
    for p0 in range(0, W * TQ, p):
        staged = None  # (row, its LUT) in "shared memory"
        for pos in range(p0, min(p0 + p, W * TQ)):
            key, slot = int(rows[pos]), int(order[pos])
            if key == -1:
                continue
            key = min(max(key, 0), table.shape[0] - 1)
            if staged is None or staged[0] != key:
                staged = (key, table[key])
            w = slot // TQ
            acc = torch.zeros(TV, dtype=torch.float32)
            for j in range(M):
                acc = acc + staged[1][j, codes[w, :, j].long()]
            cand = [(s, r) if ok else None for r, (s, ok) in enumerate(zip(acc.tolist(), valid[w].tolist()))]
            pieces = []
            for m in range(g):
                c0, c1 = nch * m // g, nch * (m + 1) // g
                sel = _WarpSelect(k)
                if c1 - c0 <= 2:
                    sel.top = sorted([c for c in cand[32 * c0:32 * c1] if c], key=lambda c: (-c[0], c[1]))[:k]
                else:
                    for c in range(c0, c1):
                        sel.offer(cand[32 * c:32 * c + 32])
                    sel.flush()
                pieces.append(sel)
            lead = pieces[0]
            for other in pieces[1:]:
                for e0 in range(0, k, 32):
                    if not lead.offer(other.top[e0:e0 + 32]):
                        break
                lead.flush()
            n = len(lead.top)
            if n:
                s = torch.tensor([c[0] for c in lead.top], dtype=torch.float32)
                out_s[slot, :n] = s
                out_i[slot, :n] = torch.where(s <= ref.NEG_INF / 2, -1,
                                              torch.tensor([c[1] for c in lead.top])).to(torch.int32)
    return out_s.reshape(W, TQ, k), out_i.reshape(W, TQ, k)


@pytest.mark.parametrize("case", ["random", "one_row", "all_padding", "ragged", "ties", "long_units"])
def test_kernel_decomposition_is_bit_exact(case):
    """The units kernel's decomposition (``_units_kernel_emulation``: ranges
    of P slots, one LUT row staged per run, a slot's rows split over g warps
    in chunks of 32, each piece sorted or filtered and merged, the pieces
    folded) equals the plain version bit for bit, ties and padding included,
    for the (P, g) the kernel picks, the other g, and W·TQ off any multiple
    of P."""
    w, tq, nv, m, u, k = {"ragged": (5, 7, 70, 4, 6, 12), "long_units": (2, 5, 300, 4, 4, 40)}.get(
        case, (4, 8, 64, 8, 6, 10))
    table, lut_idx, codes, valid = _resident_case(24, w, tq, nv, m, u)
    if case == "one_row":
        lut_idx[:] = 2
    elif case == "all_padding":
        lut_idx[:] = -1
    else:
        lut_idx[:, -2:] = -1
    if case == "ties":  # every unit's rows repeat in blocks of four: equal scores
        codes = np.repeat(codes[:, ::4], 4, axis=1)[:, :nv]
    want = workunit_pq_scan_streamed_plain(_t(table), _t(lut_idx), _t(codes), _t(valid), k=k)
    if case == "ties":
        assert (want[0][..., 1:] == want[0][..., :-1]).any()
    for p, g in sorted({units_split(nv), (1, 1), (3, 1), (1, 8), (5, 8), (128, 8)}):
        got = _units_kernel_emulation(_t(table), _t(lut_idx), _t(codes), _t(valid), k=k, p=p, g=g)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (p, g)


def test_staged_lut_rows():
    """One staged LUT row per run of a real row inside each block's range:
    a row spread over two ranges is staged twice, -1 never."""
    rows = torch.tensor([-1, -1, 0, 0, 0, 0, 0, 0, 2, 5, 5, 7], dtype=torch.int32)
    assert staged_lut_rows(rows, 8, 4) == 1 + 1 + 3  # [-1 -1 0 0] [0 0 0 0] [2 5 5 7]
    assert staged_lut_rows(rows, 8, 128) == 4
    assert staged_lut_rows(torch.full((10,), -1, dtype=torch.int32), 8, 4) == 0


def test_units_split():
    """A warp per slot up to 16 chunks of 32 rows (about 32 chunks a warp a
    block), the block's eight warps per slot beyond (about 16 a warp)."""
    assert [units_split(tv) for tv in (32, 64, 128, 256, 512, 1024, 2048, 4096)] == [
        (128, 1), (128, 1), (64, 1), (32, 1), (16, 1), (4, 8), (2, 8), (1, 8)]
    for tv in (32, 37, 64, 100, 128, 256, 300, 512, 513, 4096, 8192):
        p, g = units_split(tv)
        chunks = -(-tv // 32)
        assert 1 <= p <= 128 and g == (1 if chunks <= 16 else 8)


def test_dispatch_stats_delta_and_lut_expand():
    st = ops.DispatchStats()
    st.record_knn(("pq", 1, 2, 3, 4))
    before = st.snapshot()
    st.record_knn(("pq-res", 1, 2, 3, 4))
    st.record_merge()
    st.record_lut_expand(1000)
    st.record_candidate_bytes(77)
    d = st.delta_since(before)
    assert (d.knn_calls, d.merge_calls, d.shapes, d.lut_expand_bytes, d.peak_candidate_bytes) == (
        1, 1, {("pq-res", 1, 2, 3, 4)}, 1000, 77)


# ---------------------------------------------------------------- PQ module


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_adc_tables_and_decode_bit_equal(metric):
    rng = np.random.default_rng(4)
    vecs = rng.normal(size=(600, 32)).astype(np.float32)
    cb_ref = ref_train_pq(vecs, 8, metric=metric, iters=3, seed=1)
    cb = PQCodebook.from_state(cb_ref.to_state())
    q = rng.normal(size=(9, 32)).astype(np.float32)
    assert np.array_equal(adc_tables(cb, q), ref_adc_tables(cb_ref, q))
    codes = rng.integers(0, 256, size=(50, 8), dtype=np.uint8)
    assert np.array_equal(decode_pq(cb, codes), ref_decode_pq(cb_ref, codes))


def test_train_pq_reconstruction_near_reference():
    """The port trains on the reference's sample with its own k-means on the
    device: its reconstruction error is within 5% of the reference's."""
    rng = np.random.default_rng(8)
    vecs = rng.normal(size=(3000, 16)).astype(np.float32)
    cb_ref = ref_train_pq(vecs, 4, iters=5, seed=2, sample_cap=2048)
    cb = train_pq(vecs, 4, iters=5, seed=2, sample_cap=2048, device="cpu")
    err_ref = ((ref_decode_pq(cb_ref, ref_encode_pq(cb_ref, vecs)) - vecs) ** 2).mean()
    err = ((decode_pq(cb, encode_pq(cb, vecs, device="cpu")) - vecs) ** 2).mean()
    assert abs(err - err_ref) <= 0.05 * err_ref, (err, err_ref)


@pytest.mark.parametrize("rerank", [0, 4])
def test_pq_index_matches_reference(rerank):
    """A ``PQIndex`` over the reference's codebook and codes answers as the
    reference does (ADC through ``pq_scan``, one launch per query on a card)."""
    rng = np.random.default_rng(6)
    vecs = rng.normal(size=(800, 32)).astype(np.float32)
    r = RefPQIndex.build(vecs, m=4, metric="l2", seed=3)
    p = PQIndex(cb=PQCodebook.from_state(r.cb.to_state()), codes=_t(r.codes), vectors=vecs)
    q = rng.normal(size=(12, 32)).astype(np.float32)
    bitmap = rng.random(800) < 0.5
    for bm in (None, bitmap):
        a = r.search(q, 6, bitmap=bm, rerank=rerank)
        b = p.search(q, 6, bitmap=bm, rerank=rerank)
        assert_same_results(a[0], a[1], b[0], b[1])
    assert p.compression_ratio == r.compression_ratio


# ------------------------------------------------------------------ engine


@pytest.fixture(scope="module", params=["ip", "l2"])
def built_pq(request):
    db = small_db(metric=request.param)
    wl = small_workload(db)
    ref = RefIndex.build(db, wl, RefConfig(**CFG, scan_mode="pq"))
    return db, wl, ref.to_state()


def _with_layout(state, layout):
    state = copy.copy(state)
    state["cfg"] = dict(state["cfg"], plan=dict(state["cfg"]["plan"], merge_layout=layout))
    return state


@pytest.mark.parametrize("layout", ["segmented", "dense"])
@pytest.mark.parametrize("nprobe", ["int", "dict"])
@pytest.mark.parametrize("batch_vec", [True, False, "auto"])
def test_pq_search_matches_reference(built_pq, layout, nprobe, batch_vec):
    """A reference PQ index loaded into the port: same results, dispatch
    counts, shapes and byte accounting; no LUT expansion on the segmented
    layout, the reference's on the dense one."""
    db, wl, state = built_pq
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
    assert (a.tuples_scanned, a.bytes_scanned, a.lut_bytes, a.peak_candidate_bytes) == (
        b.tuples_scanned, b.bytes_scanned, b.lut_bytes, b.peak_candidate_bytes)
    assert ra.lut_expand_bytes == rb.lut_expand_bytes
    if batch_vec is True:
        assert (rb.lut_expand_bytes == 0) == (layout == "segmented")
        assert b.lut_bytes > 0


def test_bucket_operands_mark_padding(built_pq):
    """The engine gives padding slots the index -1 (``repro`` gives row 0),
    and each real slot its query's row of the resident table."""
    db, wl, state = built_pq
    index = HQIIndex.from_state(state, device="cpu")
    tasks, _, _ = index._engine_tasks(wl, nprobe=4, batch_vec=True, stats=ScanStats())
    plan = build_plan(index.arena, tasks, wl.vectors, m=wl.m, k=wl.k, cfg=index.cfg.plan)
    _, lut_pos = resident_luts(plan, index.arena, wl.vectors)
    n_pad = 0
    for lp in plan.buckets:
        qrow_of, _, _, lut_idx, _, _ = pq_bucket_operands(plan, index.arena, lut_pos, lp)
        li = lut_idx.numpy()
        assert (li[qrow_of < 0] == -1).all()
        assert np.array_equal(li[qrow_of >= 0], lut_pos[qrow_of[qrow_of >= 0]])
        n_pad += int((qrow_of < 0).sum())
    assert n_pad > 0


def test_attach_pq_override_matches_reference():
    """An f32-built index with a codebook attached answers
    ``search(scan_mode="pq")`` as the reference does, and its default
    search stays exact."""
    db = small_db(metric="l2", seed=2)
    wl = small_workload(db, seed=3)
    ref = RefIndex.build(db, wl, RefConfig(**CFG))
    port = HQIIndex.from_state(ref.to_state(), device="cpu")
    cb_ref = ref_train_pq(db.vectors, 4, metric=db.metric, iters=4, seed=0)
    exact = port.search(wl, nprobe=5)
    with pytest.raises(ValueError, match="attach_pq"):
        port.search(wl, nprobe=5, scan_mode="pq")
    ref.attach_pq(cb_ref)
    port.attach_pq(PQCodebook.from_state(cb_ref.to_state()))
    assert np.array_equal(port.arena.codes.numpy(), ref.arena.codes)
    for rf in (None, 2):
        a = ref.search(wl, nprobe=5, scan_mode="pq", refine_factor=rf)
        b = port.search(wl, nprobe=5, scan_mode="pq", refine_factor=rf)
        assert_same_results(a.scores, a.ids, b.scores, b.ids)
    again = port.search(wl, nprobe=5)
    assert_same_results(exact.scores, exact.ids, again.scores, again.ids)


def test_batch_search_ivf_pq_k_exceeds_posting_lists():
    """k past every list length: k′ covers every candidate, so the
    compressed path re-ranks all of them and equals f32, and both equal the
    reference's."""
    db = small_db()
    ref_ivf = RefIVF.build(db.vectors[:300], metric=db.metric, n_centroids=32, seed=0)
    ivf = IVFIndex.from_state(ref_ivf.to_state(), device="cpu")
    cb_ref = ref_train_pq(db.vectors[:300], 8, metric=db.metric, seed=0)
    cb = PQCodebook.from_state(cb_ref.to_state())
    q = np.random.default_rng(5).normal(size=(9, db.d)).astype(np.float32)
    k = 64
    cfg_f = PlanConfig(tq_unit=4, min_list_pad=8)
    cfg_p = PlanConfig(tq_unit=4, min_list_pad=8, scan_mode="pq", refine_factor=4)
    fs, fi = batch_search_ivf(ivf, q, nprobe=3, k=k, cfg=cfg_f)
    ps, pi = batch_search_ivf(ivf, q, nprobe=3, k=k, cfg=cfg_p, pq=cb)
    assert_same_results(ps, pi, fs, fi)
    assert (pi == -1).any()
    rs, ri = ref_batch_search_ivf(ref_ivf, q, nprobe=3, k=k, cfg=_ref_plan(cfg_p), pq=cb_ref)
    assert_same_results(ps, pi, rs, ri)
    with pytest.raises(ValueError, match="pq="):
        batch_search_ivf(ivf, q, nprobe=3, k=k, cfg=cfg_p)


def _ref_plan(cfg):
    from repro.core import PlanConfig as RefPlan

    return RefPlan(**{f: getattr(cfg, f) for f in ("tq_unit", "min_list_pad", "scan_mode", "refine_factor")})


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_independent_pq_build_recall(metric):
    """A port-built PQ index reaches the reference build's recall (−0.02)
    against the exact answer, and records its codebook training time."""
    kg = kg_style(n=2500, d=32, queries_per_split=80, seed=0)
    db = dataclasses.replace(kg.db, metric=metric)
    wl = kg.splits[1]
    cfg = dict(min_partition_size=256, max_leaves=8, scan_mode="pq", refine_factor=2)
    ref = RefIndex.build(db, kg.splits[0], RefConfig(**cfg))
    port = HQIIndex.build(db, kg.splits[0], HQIConfig(**cfg), device="cpu")
    assert port.pq is not None and port.build_info.pq_seconds > 0
    exact = port.search(wl, nprobe=8, scan_mode="f32")
    r_ref = recall_at_k(ref.search(wl, nprobe=8), exact)
    r_port = recall_at_k(port.search(wl, nprobe=8), exact)
    assert r_port >= r_ref - 0.02, (r_port, r_ref)


# --------------------------------------------------------------- baselines


@pytest.fixture(scope="module")
def baseline_case():
    db = small_db(metric="l2", seed=4)
    wl = small_workload(db, seed=5)
    return db, wl


@pytest.mark.parametrize("batch_vec", [False, True])
def test_prefilter_matches_reference(baseline_case, batch_vec):
    db, wl = baseline_case
    ref = RefPreFilter.build(db, seed=0)
    port = PreFilterIndex(db=db, ivf=IVFIndex.from_state(ref.ivf.to_state(), device="cpu"))
    a = ref.search(wl, nprobe=4, batch_vec=batch_vec)
    b = port.search(wl, nprobe=4, batch_vec=batch_vec)
    assert_same_results(a.scores, a.ids, b.scores, b.ids)
    assert a.tuples_scanned == b.tuples_scanned


def test_postfilter_matches_reference(baseline_case):
    db, wl = baseline_case
    ref = RefPostFilter.build(db, seed=0)
    port = PostFilterIndex(db=db, ivf=IVFIndex.from_state(ref.ivf.to_state(), device="cpu"))
    a = ref.search(wl, nprobe=4, expansion=5)
    b = port.search(wl, nprobe=4, expansion=5)
    assert_same_results(a.scores, a.ids, b.scores, b.ids)
    assert a.tuples_scanned == b.tuples_scanned


def test_range_matches_reference(baseline_case):
    db, wl = baseline_case
    ref = RefRange.build(db, "A", n_buckets=4, seed=0)
    port = RangeIndex(
        db=db, attr="A", bounds=ref.bounds,
        partitions=[(rows, IVFIndex.from_state(ivf.to_state(), device="cpu"))
                    for rows, ivf in ref.partitions],
    )
    assert RangeIndex.applicable(wl) == RefRange.applicable(wl)
    a = ref.search(wl, nprobe=3)
    b = port.search(wl, nprobe=3)
    assert_same_results(a.scores, a.ids, b.scores, b.ids)
    assert a.tuples_scanned == b.tuples_scanned
    built = RangeIndex.build(db, "A", n_buckets=4, seed=0, device="cpu")
    assert np.array_equal(built.bounds, ref.bounds)
    assert [len(r) for r, _ in built.partitions] == [len(r) for r, _ in ref.partitions]
