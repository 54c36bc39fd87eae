"""The dense layout's ADC scan (``workunit_pq_scan``): its live-slot operand
and the decomposition of its CUDA kernel, on the CPU.

``n_live`` (real query slots per unit) is held against the reference's
Pallas kernel in interpret mode on the live slots, with ``(NEG_INF, -1)`` on
the rest, through the plain version and the dispatch layer; the engine's
dense stage A passes it. ``_dense_kernel_emulation`` is the CUDA kernel's
decomposition in plain Python (a block per unit and row range, live slots G
at a time, a slot's 32-row chunks dealt over g warps tile by tile, each
warp's list sorted at once or filtered and merged, the g lists folded, the
ranges' lists folded by the last block in a shuffled order) over torch's
fp32 sums in the kernel's order; it must equal the plain version bit for
bit, ties included. It takes its launch shapes from ``torch_adc_shape``,
the C entry's rule in Python. The kernel itself is held against the plain
version on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import pq_scan as pallas
from repro_torch.core import HQIConfig, HQIIndex
from repro_torch.core.ivf import ScanStats
from repro_torch.core.plan import build_plan
from repro_torch.core.planner import live_slots, pq_bucket_operands, resident_luts
from repro_torch.core.workload import kg_style
from repro_torch.kernels import ops, ref
from repro_torch.kernels.fused_knn import MAX_K, SMEM_OPTIN_BYTES
from repro_torch.kernels.pq_scan import (
    MAX_M,
    adc_smem_bytes,
    check_pq_kernel_limits,
    workunit_pq_scan,
    workunit_pq_scan_plain,
)

from test_torch_pq import _WarpSelect, _adc_case, _t
from torch_adc_shape import adc_split, launch_shape, slot_warps

N_LIVE = {"zero": lambda tq: [0, 0, 0], "one": lambda tq: [1, 1, 1],
          "full": lambda tq: [tq] * 3, "ragged": lambda tq: [0, tq, 2]}


@pytest.mark.parametrize("pattern", sorted(N_LIVE))
def test_n_live_matches_pallas_interpret(pattern):
    """The plain version and ``ops.workunit_pq_topk`` with ``n_live``: the
    live slots equal the reference's Pallas kernel in interpret mode (scores
    within 1e-4 — XLA picks the order of the M adds — and ids equal), every
    other slot is (NEG_INF, -1)."""
    tq, k = 5, 6
    luts, codes, valid = _adc_case(len(pattern), 3, tq, 300, 4)
    n_live = np.array(N_LIVE[pattern](tq), dtype=np.int32)
    rs, ri = pallas.workunit_pq_scan(jnp.asarray(luts), jnp.asarray(codes), jnp.asarray(valid), k=k,
                                     tv=128, interpret=True)
    rs, ri = np.asarray(rs), np.asarray(ri)
    args = (_t(luts), _t(codes), _t(valid))
    nl = _t(n_live)
    got = {"ops": ops.workunit_pq_topk(*args, k, n_live=nl),
           "plain": workunit_pq_scan_plain(*args, k=k, n_live=nl),
           "wrapper": workunit_pq_scan(*args, k=k, n_live=nl)}
    live = np.arange(tq)[None, :] < n_live[:, None]
    for s, i in got.values():
        s, i = s.numpy(), i.numpy()
        np.testing.assert_allclose(s[live], rs[live], rtol=1e-4, atol=1e-4)
        assert np.array_equal(i[live], ri[live])
        assert (i[~live] == -1).all() and (s[~live] == np.float32(ref.NEG_INF)).all()


def test_n_live_none_is_every_slot_and_dead_luts_are_never_read():
    """``n_live=None`` is every slot; a full count gives the same lists; the
    LUTs of dead slots do not matter (NaN there changes nothing); a count of
    another type or shape raises."""
    luts, codes, valid = _adc_case(4, 2, 6, 90, 8)
    full = torch.full((2,), 6, dtype=torch.int32)
    a = workunit_pq_scan(_t(luts), _t(codes), _t(valid), k=5)
    b = workunit_pq_scan(_t(luts), _t(codes), _t(valid), k=5, n_live=full)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    n_live = torch.tensor([2, 4], dtype=torch.int32)
    poisoned = luts.copy()
    poisoned[0, 2:] = np.nan
    poisoned[1, 4:] = np.nan
    c = workunit_pq_scan(_t(poisoned), _t(codes), _t(valid), k=5, n_live=n_live)
    d = workunit_pq_scan(_t(luts), _t(codes), _t(valid), k=5, n_live=n_live)
    assert torch.equal(c[0], d[0]) and torch.equal(c[1], d[1])
    assert torch.equal(c[0][0, :2], a[0][0, :2]) and torch.equal(c[1][1, :4], a[1][1, :4])
    with pytest.raises(ValueError, match="n_live"):
        workunit_pq_scan(_t(luts), _t(codes), _t(valid), k=5, n_live=full.long())
    with pytest.raises(ValueError, match="n_live"):
        workunit_pq_scan(_t(luts), _t(codes), _t(valid), k=5, n_live=full[:1])


@pytest.fixture(scope="module")
def pq_index():
    kg = kg_style(n=6000, d=16, queries_per_split=60, seed=2)
    wl = kg.splits[1]
    cfg = HQIConfig(min_partition_size=128, max_leaves=16, scan_mode="pq", pq_m=4)
    return HQIIndex.build(kg.db, kg.splits[0], cfg, device="cpu"), wl


def test_pq_units_hold_their_queries_first(pq_index):
    """Every PQ bucket's units hold their real slots first, so one count per
    unit (``live_slots``) names them and their LUT rows."""
    index, wl = pq_index
    tasks, _, _ = index._engine_tasks(wl, nprobe=4, batch_vec=True, stats=ScanStats())
    plan = build_plan(index.arena, tasks, wl.vectors, m=wl.m, k=wl.k, cfg=index.cfg.plan)
    _, lut_pos = resident_luts(plan, index.arena, wl.vectors)
    assert plan.buckets
    for lp in plan.buckets:
        qrow_of, _, _, lut_idx, _, _ = pq_bucket_operands(plan, index.arena, lut_pos, lp)
        n = live_slots(qrow_of, "cpu").numpy()
        slot = np.arange(qrow_of.shape[1])[None, :]
        assert np.array_equal(qrow_of >= 0, slot < n[:, None])
        assert np.array_equal(lut_idx.numpy() >= 0, slot < n[:, None])


def test_dense_stage_a_passes_the_live_slots(pq_index, monkeypatch):
    """The dense layout's stage A hands every dispatch its buckets' live-slot
    counts, and its answers equal the segmented layout's."""
    index, wl = pq_index
    seen = []
    real = ops.workunit_pq_topk

    def spy(luts, codes, valid, k, *, n_live=None):
        seen.append((luts.shape[0], luts.shape[1], n_live))
        return real(luts, codes, valid, k, n_live=n_live)

    monkeypatch.setattr(ops, "workunit_pq_topk", spy)
    seg = index.search(wl, nprobe=4)
    index.cfg.plan.merge_layout = "dense"
    try:
        dense = index.search(wl, nprobe=4)
    finally:
        index.cfg.plan.merge_layout = "segmented"
    assert seen
    for w, tq, n_live in seen:
        assert n_live is not None and n_live.dtype == torch.int32 and n_live.shape == (w,)
        assert 0 <= int(n_live.min()) and int(n_live.max()) <= tq and int(n_live.sum()) > 0
    assert np.array_equal(seg.ids, dense.ids) and np.array_equal(seg.scores, dense.scores)


# ------------------------------------------------------ the decomposition


def _offer_sorted(sel, lst, k):
    """A sorted list offered 32 entries at a time up to its first chunk the
    filter rejects in part (``WarpSelect::offer_list``)."""
    for e0 in range(0, k, 32):
        if not sel.offer(lst[e0:e0 + 32]):
            break


def _dense_kernel_emulation(luts, codes, valid, *, k, n_live=None, G=None, g=None, S=None, seed=0):
    """The dense-layout kernel's decomposition over torch's fp32 sums: a
    block per (unit, slot group of G live slots, range of ``per`` 32-row
    chunks, ``per`` as the C entry derives it from S) — which block of a
    unit takes a group (Y) changes no list; a slot's LUT row scores its rows
    (m = 0 … M-1 in order); warp j of the slot takes the range's chunks c
    with c % g == j in order (whatever chunks a ring tile holds); a warp
    with at most two chunks sorts its rows at once, else offers them chunk
    by chunk (filtered against the k-th entry, buffered, merged 32 at a
    time); the slot's g lists fold into the first; at S > 1 the S ranges'
    lists fold in a shuffled order (the last block sees them in whatever
    order they were stored). Defaults: the kernel's own (G, g) and S.
    Returns what the kernel writes."""
    W, TQ, M = luts.shape[:3]
    TV = codes.shape[1]
    G0, g0, _ = slot_warps(M, TQ)
    G, g = G or G0, g or g0
    nch = -(-TV // 32)
    S = adc_split(W, TQ, TV, G)[1] if S is None else S
    per = -(-nch // S)
    S = -(-nch // per)
    rng = random.Random(seed)
    out_s = torch.full((W, TQ, k), ref.NEG_INF, dtype=torch.float32)
    out_i = torch.full((W, TQ, k), -1, dtype=torch.int32)
    for w in range(W):
        n = TQ if n_live is None else min(max(int(n_live[w]), 0), TQ)
        for grp in range(-(-n // G)):
            for mine in range(G):
                slot = grp * G + mine
                if slot >= n:
                    continue
                acc = torch.zeros(TV, dtype=torch.float32)
                for j in range(M):
                    acc = acc + luts[w, slot, j, codes[w, :, j].long()]
                cand = [(s, r) if ok else None for r, (s, ok) in enumerate(zip(acc.tolist(), valid[w].tolist()))]
                partial = []
                for z in range(S):
                    row0, row1 = z * per * 32, min(TV, (z + 1) * per * 32)
                    nch_r = -(-(row1 - row0) // 32)
                    pieces = []
                    for sub in range(g):
                        chunks = [cand[row0 + 32 * c:min(row1, row0 + 32 * c + 32)]
                                  for c in range(sub, nch_r, g)]
                        sel = _WarpSelect(k)
                        if nch_r <= 2 * g:
                            sel.top = sorted([c for ch in chunks for c in ch if c],
                                             key=lambda c: (-c[0], c[1]))[:k]
                        else:
                            for ch in chunks:
                                sel.offer(ch)
                            sel.flush()
                        pieces.append(sel)
                    lead = pieces[0]
                    for other in pieces[1:]:
                        _offer_sorted(lead, other.top, k)
                        lead.flush()
                    partial.append(lead.top[:k])
                if S == 1:
                    final = partial[0]
                else:
                    order = list(range(S))
                    rng.shuffle(order)
                    sel = _WarpSelect(k)
                    for z in order:
                        _offer_sorted(sel, partial[z], k)
                    sel.flush()
                    final = sel.top
                if final:
                    s = torch.tensor([c[0] for c in final], dtype=torch.float32)
                    out_s[w, slot, :len(final)] = s
                    out_i[w, slot, :len(final)] = torch.where(
                        s <= ref.NEG_INF / 2, -1, torch.tensor([c[1] for c in final])).to(torch.int32)
    return out_s, out_i


EMULATED = {  # (W, TQ, TV, M, k, density, dup, n_live)
    "random_m8": (3, 9, 300, 8, 10, 0.6, False, [9, 4, 0]),
    "random_m16": (2, 7, 200, 16, 12, 0.7, False, [7, 3]),
    "ties_m8": (2, 12, 260, 8, 16, 0.8, True, [12, 5]),
    "ties_m16": (2, 6, 100, 16, 40, 0.9, True, [6, 6]),
    "long_units": (2, 3, 1500, 8, 40, 0.5, True, [3, 1]),
    "short_units": (4, 16, 64, 8, 40, 0.7, False, [16, 1, 0, 9]),
    "sparse": (3, 5, 400, 8, 12, 0.02, False, None),
    "one_query": (3, 1, 500, 8, 10, 0.5, True, [1, 0, 1]),
}


def _emulation_case(name):
    W, TQ, TV, M, k, density, dup, n_live = EMULATED[name]
    luts, codes, valid = _adc_case(len(name) + M, W, TQ, TV, M, density)
    if dup:  # every unit's rows repeat in blocks of four: exact ties
        codes = np.repeat(codes[:, ::4], 4, axis=1)[:, :TV].copy()
    nl = None if n_live is None else torch.tensor(n_live, dtype=torch.int32)
    return _t(luts), _t(codes), _t(valid), k, nl


@pytest.mark.parametrize("case", sorted(EMULATED))
def test_kernel_decomposition_is_bit_exact(case):
    """``_dense_kernel_emulation`` equals the plain version bit for bit, ties
    and dead slots included, at the kernel's (G, g) and S, at one slot and
    one warp a block, at a slot spread over 2 and 8 warps, and at S = 1, 2,
    3 and the most ranges (one 32-row chunk each)."""
    luts, codes, valid, k, n_live = _emulation_case(case)
    TV = codes.shape[1]
    want = workunit_pq_scan_plain(luts, codes, valid, k=k, n_live=n_live)
    if EMULATED[case][6]:
        assert (want[0][..., 1:] == want[0][..., :-1]).any()
    for G, g, S in sorted({(None, None, None), (1, 1, 1), (2, 2, 2), (1, 8, 3), (4, 1, -(-TV // 32))},
                          key=str):
        got = _dense_kernel_emulation(luts, codes, valid, k=k, n_live=n_live, G=G, g=g, S=S)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (G, g, S)


@pytest.mark.parametrize("m", [8, 16])
def test_delta_store_shape_is_bit_exact(m):
    """The delta store's shape (few long units: W 3, TQ 16, TV 2048), zero
    LUTs on the padding slots past each unit's count, k′ 40: the kernel's
    split (S > 1, the last block folding the ranges' lists in a shuffled
    order) and a slot over eight warps equal the plain version bit for bit."""
    W, TQ, TV, k = 3, 16, 2048, 40
    luts, codes, valid = _adc_case(30 + m, W, TQ, TV, m)
    n_live = np.array([16, 5, 1], dtype=np.int32)
    luts[np.arange(TQ)[None, :] >= n_live[:, None]] = 0.0
    codes = np.repeat(codes[:, ::2], 2, axis=1)[:, :TV].copy()  # ties
    args = (_t(luts), _t(codes), _t(valid))
    nl = _t(n_live)
    want = workunit_pq_scan_plain(*args, k=k, n_live=nl)
    assert adc_split(W, TQ, TV, slot_warps(m, TQ)[0])[1] > 1
    for G, g, seed in ((None, None, 0), (None, None, 1), (1, 8, 2)):
        got = _dense_kernel_emulation(*args, k=k, n_live=nl, G=G, g=g, seed=seed)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (G, g, seed)


# ------------------------------------------------------ shapes and limits


@pytest.mark.parametrize(
    "m,tq,want",
    [(4, 64, (8, 1, 4)), (8, 64, (8, 1, 4)), (8, 3, (4, 2, 4)), (8, 1, (1, 8, 8)), (12, 64, (4, 2, 4)),
     (16, 64, (4, 2, 4)), (32, 64, (2, 4, 4)), (64, 64, (1, 8, 8)), (100, 64, (1, 4, 4)),
     (128, 64, (1, 4, 4)), (181, 64, (1, 1, 1)), (MAX_M, 64, (1, 1, 1))],
)
def test_slot_warps(m, tq, want):
    """G from M: 64 KiB of LUT rows a block (three blocks an SM at M 8), at
    most 8 slots and no more than TQ needs; g fills eight warps and halves
    until the block fits shared memory; a tile holds 4 chunks, or g, where
    that fits."""
    G, g, T = slot_warps(m, tq)
    assert (G, g, T) == want
    assert G * g <= 8 and G & (G - 1) == 0 and g & (g - 1) == 0 and T % g == 0
    assert adc_smem_bytes(m, G, g, T) <= SMEM_OPTIN_BYTES
    assert G == 1 or G * m <= 64
    if m == 8 and tq == 64:
        assert 3 * (adc_smem_bytes(m, G, g, T) + 1024) <= 228 * 1024


@pytest.mark.parametrize(
    "w,tq,tv,want",
    [(2048, 64, 64, (1, 1)), (1024, 64, 128, (1, 1)), (128, 64, 256, (6, 1)), (256, 64, 1024, (3, 1)),
     (8, 64, 512, (8, 2)), (8, 64, 4096, (8, 12)), (16, 128, 32768, (16, 3)), (3, 16, 2048, (2, 8)),
     (1, 1, 200, (1, 1)), (1, 1, 100_000, (1, 348))],
)
def test_adc_split(w, tq, tv, want):
    """Blocks per unit: slot groups first, then rows in whole 32-row chunks
    of at least 8, until the grid reaches two waves of 3 · 132 blocks;
    every range non-empty with the chunk count the C entry derives; the
    engine's heavy buckets are one block a unit."""
    G = slot_warps(8, tq)[0]
    Y, s = adc_split(w, tq, tv, G)
    assert (Y, s) == want
    assert 1 <= Y <= -(-tq // G) and (Y == 1 or w * Y <= 2 * 3 * 132)
    nch = -(-tv // 32)
    per = -(-nch // s)
    assert (s - 1) * per < nch <= s * per
    assert s == 1 or (nch // s >= 8 and w * Y * s <= 2 * 2 * 3 * 132)


@pytest.mark.parametrize(
    "k,m,fits",
    [(40, 8, True), (MAX_K, 181, True), (MAX_K + 1, 8, False), (10, MAX_M, True),
     (10, MAX_M + 1, False)],
)
def test_max_m_keeps_every_m_that_ran(k, m, fits):
    """``MAX_M`` (one slot's LUT row, a ring and one warp) is at least 181,
    the widest M the dense layout's kernel took before; past it the check
    names the limit."""
    assert MAX_M >= 181
    if fits:
        check_pq_kernel_limits(k, m)
    else:
        with pytest.raises(ValueError, match=f"k={k}" if k > MAX_K else f"M={m}: the dense-layout"):
            check_pq_kernel_limits(k, m)
