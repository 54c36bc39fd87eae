"""The CUDA kernels of the port against their plain PyTorch versions, on the
card: both ``fused_knn`` grids, the three ADC wrappers of ``pq_scan`` (the
LUT-stationary kernels and ``adc_slot_warps_kernel``) and
``flash_attention`` (with the reduced LM served on the card against the CPU).
Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels are CUDA C++ with no CPU mode).

This file imports neither jax nor the reference package, so it also runs
where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import HQIConfig, HQIIndex, kg_style
from repro_torch.core.pq import PQIndex, train_pq
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import pq_scan as adc
from repro_torch.kernels.fused_knn import MAX_K, fused_knn, fused_knn_db_stationary, fused_knn_plain

ROOT = Path(__file__).resolve().parents[1]
GRIDS = {"fused_knn": fused_knn, "fused_knn_db_stationary": fused_knn_db_stationary}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ with no CPU mode")
    return torch.device("cuda")


def _case(dev, seed, W, TQ, TV, D, density=0.7, dtype=torch.float32):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((W, TQ, D), generator=g, device=dev).to(dtype)
    v = torch.randn((W, TV, D), generator=g, device=dev).to(dtype)
    valid = torch.rand((W, TV), generator=g, device=dev) < density
    return q, v, valid


def _check(got, want, tol):
    """Scores within ``tol``; the same absent slots; equal ids wherever the
    plain version's neighbouring scores are apart by more than ``tol``."""
    gs, gi = got
    ws, wi = want
    torch.testing.assert_close(gs, ws, rtol=tol, atol=tol)
    assert torch.equal(gi < 0, wi < 0)
    gap = tol * (1 + ws.abs())
    tied = torch.zeros_like(wi, dtype=torch.bool)
    near = (ws[..., 1:] - ws[..., :-1]).abs() <= gap[..., 1:]
    tied[..., 1:] |= near
    tied[..., :-1] |= near
    tied[..., -1] = True  # may tie with the first row left out
    assert torch.equal(gi[~tied], wi[~tied])


def _traced(fn, wrapper, kernel):
    """(fn()'s result, the device kernel names of its trace), one call of
    ``fn`` a trace adding one launch to ``wrapper.launches``. Once the
    process has run a while, torch.profiler drops the device records at the
    start of a trace (chip_smoke.py's ``device_ms`` works around the same),
    so the call is queued behind pad launches and a device sleep, and the
    trace is taken again behind a longer sleep while it holds no launch of
    ``kernel``."""
    pad = torch.zeros(1024, dtype=torch.int32, device="cuda")
    for lead_ms in (20.0, 200.0, 2000.0):
        n0 = wrapper.launches
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(64):
                pad.bitwise_not_()
            torch.cuda._sleep(int(lead_ms * 2.0e6))  # cycles at ~2 GHz
            out = fn()
            torch.cuda.synchronize()
        assert wrapper.launches == n0 + 1
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if any(kernel in n for n in names):
            break
    return out, names


@pytest.mark.cuda
@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("k", [1, 8, 10, 16, 32, MAX_K])  # every register-list size
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_every_list_size(dev, grid, k, metric):
    q, v, valid = _case(dev, k, 32, 64, 600, 64)
    fn = GRIDS[grid]
    n0 = fn.launches
    got = fn(q, v, valid, k=k, metric=metric)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    _check(got, fused_knn_plain(q, v, valid, k=k, metric=metric), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize(
    "W,TQ,TV,D",
    [(1, 1, 16, 8), (3, 5, 37, 7), (4, 100, 300, 63), (2, 130, 1100, 16), (8, 64, 96, 256)],
)
def test_ragged_shapes(dev, grid, W, TQ, TV, D):
    """Query counts off the 64-query chunk, odd widths, TV off every tile."""
    q, v, valid = _case(dev, W * TQ + TV, W, TQ, TV, D)
    k = min(10, TV)
    got = GRIDS[grid](q, v, valid, k=k, metric="l2")
    _check(got, fused_knn_plain(q, v, valid, k=k, metric="l2"), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_bf16_and_sparse_masks(dev, grid):
    fn = GRIDS[grid]
    q, v, valid = _case(dev, 1, 16, 64, 1024, 64, dtype=torch.bfloat16)
    _check(fn(q, v, valid, k=10), fused_knn_plain(q, v, valid, k=10), 2e-2)
    valid = torch.zeros_like(valid)
    s, i = fn(q, v, valid, k=10)
    assert (i == -1).all() and (s == -3.4e38).all()
    valid[:, [3, 700]] = True
    s, i = fn(q, v, valid, k=4)
    assert (i[..., 2:] == -1).all() and (s[..., 2:] == -3.4e38).all()
    assert set(i[..., :2].unique().tolist()) == {3, 700}


@pytest.mark.cuda
def test_ties_go_to_the_smallest_index(dev):
    """Duplicated rows score exactly alike; both grids and the plain version
    rank them by index."""
    q, v, valid = _case(dev, 2, 4, 8, 700, 16, density=1.0)
    v[:, 100:700:50] = v[:, 5:6]
    want = fused_knn_plain(q, v, valid, k=16, metric="ip")
    for fn in GRIDS.values():
        s, i = fn(q, v, valid, k=16, metric="ip")
        assert torch.equal(s, want[0]) or torch.allclose(s, want[0], rtol=1e-5, atol=1e-5)
        dup = torch.isin(i, torch.tensor([5] + list(range(100, 700, 50)), device=dev))
        for row_i, row_d in zip(i.reshape(-1, 16), dup.reshape(-1, 16)):
            ids = row_i[row_d].tolist()
            assert ids == sorted(ids)


@pytest.mark.cuda
def test_rejects_what_the_kernels_do_not_take(dev):
    """A k past the lists' MAX_K is taken in passes (it is no longer
    refused); a non-contiguous input still is."""
    q, v, valid = _case(dev, 3, 2, 8, 128, 16)
    n0 = fused_knn.launches
    got = fused_knn(q, v, valid, k=MAX_K + 1)
    assert fused_knn.launches == n0 + 2
    _check(got, fused_knn_plain(q, v, valid, k=MAX_K + 1), 1e-4)
    with pytest.raises(ValueError, match="contiguous"):
        fused_knn(q.transpose(1, 2).contiguous().transpose(1, 2), v, valid, k=4)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("d", [453, 454, 768, 1024])
def test_widest_rows_the_tiles_hold(dev, grid, d):
    """Rows are staged 64 elements at a time, so any width runs: d 453 (the
    widest the whole-row tiles of the first version held), 454, and the
    768 and 1024 of text-encoder embeddings match the plain version."""
    fn = GRIDS[grid]
    q, v, valid = _case(dev, d, 2, 64, 300, d)
    for metric in ("ip", "l2"):
        _check(fn(q, v, valid, k=10, metric=metric), fused_knn_plain(q, v, valid, k=10, metric=metric),
               1e-4)


def _n_live(dev, W, TQ, pattern):
    g = torch.Generator(device="cpu").manual_seed(W + TQ)
    n = {"zero": torch.zeros(W, dtype=torch.int32), "one": torch.ones(W, dtype=torch.int32),
         "full": torch.full((W,), TQ, dtype=torch.int32),
         "ragged": torch.randint(0, TQ + 1, (W,), generator=g, dtype=torch.int32)}[pattern]
    return n.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("pattern", ["zero", "one", "ragged", "full"])
@pytest.mark.parametrize("W,TQ,TV", [(64, 64, 64), (16, 100, 300), (4, 64, 4096)])
def test_live_slots(dev, grid, pattern, W, TQ, TV):
    """``n_live``: the live slots match the plain version, every other slot
    is (NEG_INF, -1); the plain version honours it the same way."""
    q, v, valid = _case(dev, W + TV, W, TQ, TV, 64, density=0.3)
    n_live = _n_live(dev, W, TQ, pattern)
    for metric in ("ip", "l2"):
        got = GRIDS[grid](q, v, valid, k=10, metric=metric, n_live=n_live)
        want = fused_knn_plain(q, v, valid, k=10, metric=metric, n_live=n_live)
        _check(got, want, 1e-4)
        dead = torch.arange(TQ, device=dev)[None, :] >= n_live[:, None]
        assert (got[1][dead] == -1).all() and (got[0][dead] == -3.4e38).all()


@pytest.mark.cuda
@pytest.mark.parametrize("W", [2, 64])
@pytest.mark.parametrize("k", [10, MAX_K])
def test_split_rows_merge_in_one_launch(dev, W, k):
    """TV 4096 splits a unit's rows over many blocks (``split_count``, the
    same in Python and C); the last block merges their lists in the same
    launch: the profiler sees one kernel launch and no merge kernel."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_knn import split_count

    q, v, valid = _case(dev, W, W, 64, 4096, 64)
    lib = _build.library("fused_knn")
    for shape in ((W, 64, 4096), (W, 1, 4096), (3, 130, 1100), (16384, 64, 64), (8, 64, 4096)):
        assert lib.fused_knn_split_count(*shape) == split_count(*shape), shape
    assert split_count(W, 64, 4096) > 1
    fn = fused_knn_db_stationary
    _check(fn(q, v, valid, k=k, metric="l2"), fused_knn_plain(q, v, valid, k=k, metric="l2"), 1e-4)
    torch.cuda.synchronize()
    _, names = _traced(lambda: fn(q, v, valid, k=k), fn, "fused_knn")
    assert sum("fused_knn" in n for n in names) == 1, names
    assert not any("merge_partials" in n for n in names), names


@pytest.mark.cuda
@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("W,TV,density", [(16384, 40, 0.7), (37, 40, 0.2), (5, 3000, 0.5)])
def test_units_of_one_query(dev, grid, W, TV, density):
    """TQ = 1 (the PQ path's re-rank: a warp per unit), with padding units
    (n_live 0) as the engine passes them."""
    q, v, valid = _case(dev, W + TV, W, 1, TV, 64, density=density)
    n_live = (torch.arange(W, device=dev) < W - W // 4).to(torch.int32)
    k = min(10, TV)
    for metric in ("ip", "l2"):
        got = GRIDS[grid](q, v, valid, k=k, metric=metric, n_live=n_live)
        _check(got, fused_knn_plain(q, v, valid, k=k, metric=metric, n_live=n_live), 1e-4)


@pytest.mark.cuda
def test_ties_across_split_boundaries(dev):
    """One row duplicated into every 64-row tile of a 4096-row unit, so the
    copies fall in different blocks of the split grid: both grids return
    them in index order, equal to the plain version."""
    q, v, valid = _case(dev, 9, 2, 64, 4096, 32, density=1.0)
    copies = list(range(5, 4096, 64))
    v[:, copies] = v[:, 5:6]
    q[:, :, :] = v[:, 5:6] + 0.01 * q  # the copies rank first
    want = fused_knn_plain(q, v, valid, k=MAX_K, metric="ip")
    for fn in GRIDS.values():
        s, i = fn(q, v, valid, k=MAX_K, metric="ip")
        assert torch.equal(i, want[1])
        torch.testing.assert_close(s, want[0], rtol=1e-4, atol=1e-4)
        dup = torch.isin(i, torch.tensor(copies, device=dev))
        for row_i, row_d in zip(i.reshape(-1, MAX_K), dup.reshape(-1, MAX_K)):
            ids = row_i[row_d].tolist()
            assert ids == sorted(ids) and len(ids) == len(copies)


@pytest.mark.cuda
def test_wide_index_searches_on_the_card(dev):
    """An index of 768-wide vectors searches on the card and answers as its
    CPU reload does."""
    kg = kg_style(n=20_000, d=768, queries_per_split=40, seed=0)
    wl = kg.splits[1]
    index = HQIIndex.build(kg.db, kg.splits[0], HQIConfig(), device=dev)
    n0 = fused_knn.launches + fused_knn_db_stationary.launches
    a = index.search(wl, nprobe=8)
    assert fused_knn.launches + fused_knn_db_stationary.launches > n0
    b = HQIIndex.from_state(index.to_state(), device="cpu").search(wl, nprobe=8)
    torch.testing.assert_close(torch.from_numpy(a.scores), torch.from_numpy(b.scores),
                               rtol=1e-4, atol=1e-4)
    for r in range(wl.m):
        assert set(a.ids[r][a.ids[r] >= 0].tolist()) == set(b.ids[r][b.ids[r] >= 0].tolist())


@pytest.mark.cuda
def test_engine_names_the_kernel_limits(dev):
    """k above MAX_K on a card index runs the kernels in passes and answers
    as the same index reloaded on the CPU (scores within 1e-4, equal id
    sets)."""
    kg = kg_style(n=20_000, d=16, queries_per_split=40, seed=0)
    wl = dataclasses.replace(kg.splits[1], k=MAX_K + 1)
    index = HQIIndex.build(kg.db, kg.splits[0], HQIConfig(), device=dev)
    n0 = fused_knn.launches + fused_knn_db_stationary.launches
    got = index.search(wl, nprobe=8)
    assert fused_knn.launches + fused_knn_db_stationary.launches > n0
    res = HQIIndex.from_state(index.to_state(), device="cpu").search(wl, nprobe=8)
    assert got.ids.shape == res.ids.shape == (wl.m, MAX_K + 1)
    torch.testing.assert_close(torch.from_numpy(got.scores), torch.from_numpy(res.scores),
                               rtol=1e-4, atol=1e-4)
    for r in range(wl.m):
        assert set(got.ids[r].tolist()) == set(res.ids[r].tolist())


# ------------------------------------------------------------- ADC kernels


def _adc_case(dev, seed, W, TQ, TV, M, density=0.7, U=None):
    """Random LUTs (as a resident table of U rows, with per-slot indices and
    some padding slots at row 0), uint8 codes and a mask."""
    g = torch.Generator(device=dev).manual_seed(seed)
    U = U or W * TQ
    table = torch.randn((U, M, 256), generator=g, device=dev)
    lut_idx = torch.randint(0, U, (W, TQ), generator=g, device=dev, dtype=torch.int32)
    lut_idx[:, TQ - TQ // 4:] = 0  # padding slots read row 0
    codes = torch.randint(0, 256, (W, TV, M), generator=g, device=dev, dtype=torch.uint8)
    valid = torch.rand((W, TV), generator=g, device=dev) < density
    return table, lut_idx, codes, valid


def _adc_run(name, table, lut_idx, codes, valid, k):
    """(kernel result, plain result) of one ADC wrapper on the same inputs."""
    if name == "workunit_pq_scan_streamed":
        return (adc.workunit_pq_scan_streamed(table, lut_idx, codes, valid, k=k),
                adc.workunit_pq_scan_streamed_plain(table, lut_idx, codes, valid, k=k))
    if name == "workunit_pq_scan":
        luts = table[lut_idx.long()].contiguous()
        return (adc.workunit_pq_scan(luts, codes, valid, k=k),
                adc.workunit_pq_scan_plain(luts, codes, valid, k=k))
    lut, c, v = table[lut_idx[0, 0].long()].contiguous(), codes[0], valid[0]
    return adc.pq_scan(lut, c, v, k=k), adc.pq_scan_plain(lut, c, v, k=k)


ADC = ["workunit_pq_scan_streamed", "workunit_pq_scan", "pq_scan"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ADC)
@pytest.mark.parametrize("k", [1, 8, 10, 16, 32, 40, MAX_K])  # every register-list size
def test_adc_every_list_size(dev, name, k):
    """The kernel sums the M lookups in the plain version's order, so the two
    agree bit for bit: equal scores and equal ids."""
    table, lut_idx, codes, valid = _adc_case(dev, k, 16, 64, 1500, 8)
    fn = getattr(adc, name)
    n0 = fn.launches
    (gs, gi), (ws, wi) = _adc_run(name, table, lut_idx, codes, valid, k)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    assert torch.equal(gs, ws) and torch.equal(gi, wi)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ADC)
@pytest.mark.parametrize(
    "W,TQ,TV,M",
    [(1, 1, 16, 4), (3, 5, 37, 8), (4, 100, 300, 16), (2, 130, 1100, 8), (2, 64, 4096, 8),
     (5, 3, 70, 12), (1, 1, 200_003, 8)],
)
def test_adc_ragged_shapes(dev, name, W, TQ, TV, M):
    """Query counts off the chunk, M in {4, 8, 12, 16}, TV off the 256-row
    tile and the 1024-row split, and a long single query (the one-query
    grid's block split)."""
    table, lut_idx, codes, valid = _adc_case(dev, W * TQ + TV, W, TQ, TV, M)
    k = min(10, TV)
    got, want = _adc_run(name, table, lut_idx, codes, valid, k)
    _check(got, want, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ADC)
def test_adc_sparse_masks(dev, name):
    """All-invalid, and 2 valid rows of 1024 with k=4: unfilled slots are
    (NEG_INF, -1), not the Pallas kernels' leaked ids."""
    table, lut_idx, codes, valid = _adc_case(dev, 5, 4, 8, 1024, 8)
    (s, i), _ = _adc_run(name, table, lut_idx, codes, torch.zeros_like(valid), 10)
    assert (i == -1).all() and (s == -3.4e38).all()
    two = torch.zeros_like(valid)
    two[:, [3, 700]] = True
    (s, i), (ws, wi) = _adc_run(name, table, lut_idx, codes, two, 4)
    assert (i[..., 2:] == -1).all() and (s[..., 2:] == -3.4e38).all()
    assert set(i[..., :2].unique().tolist()) == {3, 700}
    assert torch.equal(s, ws) and torch.equal(i, wi)


@pytest.mark.cuda
def test_adc_limits(dev):
    """k above MAX_K runs in two passes, bit-equal to the plain version; a
    non-contiguous input raises before launch; the widest staged M
    (``MAX_M``) and the next (``adc_wide_m_kernel``) both run and match bit
    for bit."""
    table, lut_idx, codes, valid = _adc_case(dev, 6, 2, 8, 300, 8)
    n0 = adc.workunit_pq_scan_streamed.launches
    got = adc.workunit_pq_scan_streamed(table, lut_idx, codes, valid, k=MAX_K + 1)
    want = adc.workunit_pq_scan_streamed_plain(table, lut_idx, codes, valid, k=MAX_K + 1)
    assert adc.workunit_pq_scan_streamed.launches == n0 + 2
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="contiguous"):
        adc.workunit_pq_scan_streamed(table, lut_idx.t().contiguous().t(), codes, valid, k=4)
    assert adc.workunit_pq_scan_streamed.launches == n0 + 2
    for name in ("pq_scan", "workunit_pq_scan"):
        for M in (adc.MAX_M, adc.MAX_M + 1):
            table, lut_idx, codes, valid = _adc_case(dev, 7, 1, 1, 500, M)
            (gs, gi), (ws, wi) = _adc_run(name, table, lut_idx, codes, valid, 10)
            assert torch.equal(gs, ws) and torch.equal(gi, wi), (name, M)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["workunit_pq_scan_streamed", "pq_scan"])
@pytest.mark.parametrize("delta", [-1, 0, 1])
def test_lut_stationary_m_limit(dev, name, delta):
    """M at the LUT-stationary limit ± 1: below and at it the kernel runs,
    above it ``adc_wide_m_kernel``; each launches once and equals the plain
    version bit for bit."""
    M = adc.MAX_M + delta
    table, lut_idx, codes, valid = _adc_case(dev, 8 + delta, 3, 16, 200, M)
    fn = adc.adc_wide_m if delta > 0 else getattr(adc, name)
    n0 = fn.launches
    (gs, gi), (ws, wi) = _adc_run(name, table, lut_idx, codes, valid, 10)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    assert torch.equal(gs, ws) and torch.equal(gi, wi)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "W,TQ,TV,M,k",
    [(64, 64, 64, 8, 40), (8, 64, 4096, 8, 64), (5, 3, 37, 12, 10), (7, 9, 100, 5, 33), (3, 64, 1100, 16, 64)],
)
def test_lut_stationary_units(dev, W, TQ, TV, M, k):
    """The units kernel on the engine's heaviest bucket shape, k′ 64 at TV
    4096 (eight warps a slot), and sources off the 16-byte grid (TV 37, M
    5): a quarter of the slots are padding (-1), the rest read random rows;
    bit-equal to the plain version, padding (NEG_INF, -1)."""
    table, lut_idx, codes, valid = _adc_case(dev, W + TV + k, W, TQ, TV, M, U=97)
    lut_idx[:, TQ - TQ // 4:] = -1
    got = adc.workunit_pq_scan_streamed(table, lut_idx, codes, valid, k=k)
    want = adc.workunit_pq_scan_streamed_plain(table, lut_idx, codes, valid, k=k)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    pad = lut_idx == -1
    assert (got[1][pad] == -1).all() and (got[0][pad] == -3.4e38).all()


@pytest.mark.cuda
@pytest.mark.parametrize("tv", [64, 1100])  # a warp a slot; eight warps a slot
@pytest.mark.parametrize("case", ["one_row", "all_padding", "one_row_and_padding"])
def test_lut_stationary_heavy_row_and_padding(dev, case, tv):
    """Every slot on one table row (a hot query spread over all blocks), every
    slot -1, and one row beside padding; W·TQ off every block range."""
    table, lut_idx, codes, valid = _adc_case(dev, 9, 333, 7, tv, 8, U=5)
    if case == "one_row":
        lut_idx[:] = 3
    elif case == "all_padding":
        lut_idx[:] = -1
    else:
        lut_idx[:] = 3
        lut_idx[::2, 1:] = -1
    n0 = adc.workunit_pq_scan_streamed.launches
    got = adc.workunit_pq_scan_streamed(table, lut_idx, codes, valid, k=40)
    want = adc.workunit_pq_scan_streamed_plain(table, lut_idx, codes, valid, k=40)
    torch.cuda.synchronize()
    assert adc.workunit_pq_scan_streamed.launches == n0 + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["workunit_pq_scan_streamed", "pq_scan"])
@pytest.mark.parametrize("W,TQ,TV", [(64, 64, 64), (3, 20, 1100), (1, 1, 200_003)])
@pytest.mark.parametrize("M", [110, 128, 190])
def test_lut_stationary_sliced_rows(dev, name, W, TQ, TV, M):
    """M past ``WHOLE_ROW_MAX_M``: the LUT row passes through shared memory
    in slices; a warp a slot (TV 64), eight warps a slot (TV 1100), the rows
    kernel over 200,003 rows; some slots padding. One launch, bit-equal to
    the plain version."""
    table, lut_idx, codes, valid = _adc_case(dev, M + TV, W, TQ, TV, M, U=97)
    lut_idx[:, TQ - TQ // 4:] = -1
    if name == "pq_scan":
        lut_idx[0, 0] = 5
    fn = getattr(adc, name)
    n0 = fn.launches
    (gs, gi), (ws, wi) = _adc_run(name, table, lut_idx, codes, valid, 40)
    torch.cuda.synchronize()
    assert adc.lut_stationary_slice(M) < M and fn.launches == n0 + 1
    assert torch.equal(gs, ws) and torch.equal(gi, wi)


@pytest.mark.cuda
def test_wide_pq_index_searches_on_the_card(dev):
    """d 256 at pq_m 128 (the LUT row in slices): the segmented PQ engine
    launches kernel 3 and ``PQIndex.search`` kernel 5, no ValueError; each
    agrees with the same index on the CPU."""
    kg = kg_style(n=5_000, d=256, queries_per_split=40, seed=3)
    wl = kg.splits[1]
    index = HQIIndex.build(kg.db, kg.splits[0], HQIConfig(scan_mode="pq", pq_m=128), device=dev)
    n3 = adc.workunit_pq_scan_streamed.launches
    a = index.search(wl, nprobe=8)
    assert adc.workunit_pq_scan_streamed.launches > n3
    b = HQIIndex.from_state(index.to_state(), device="cpu").search(wl, nprobe=8)
    _same_answers((a.scores, a.ids), (b.scores, b.ids))
    pq_idx = PQIndex.build(kg.db.vectors, m=128, device=dev)
    n5 = adc.pq_scan.launches
    a = pq_idx.search(wl.vectors, k=10)
    assert adc.pq_scan.launches > n5
    b = dataclasses.replace(pq_idx, codes=pq_idx.codes.cpu()).search(wl.vectors, k=10)
    _same_answers(a, b)


def _same_answers(a, b):
    """(scores, ids) pairs: scores within 1e-4, equal id sets per row."""
    torch.testing.assert_close(torch.from_numpy(a[0]), torch.from_numpy(b[0]), rtol=1e-4, atol=1e-4)
    for ra, rb in zip(a[1], b[1]):
        assert set(ra[ra >= 0].tolist()) == set(rb[rb >= 0].tolist())


@pytest.mark.cuda
def test_pq_scan_is_one_launch_at_a_million_rows(dev):
    """pq_scan at NV 10^6: one launch of the LUT-stationary rows kernel (the
    blocks' lists merge inside it), no merge kernel, bit-equal to the plain
    version."""
    g = torch.Generator(device=dev).manual_seed(10)
    lut = torch.randn((8, 256), generator=g, device=dev)
    codes = torch.randint(0, 256, (1_000_000, 8), generator=g, device=dev, dtype=torch.uint8)
    valid = torch.rand((1_000_000,), generator=g, device=dev) < 0.7
    adc.pq_scan(lut, codes, valid, k=40)  # built and warm
    torch.cuda.synchronize()
    got, names = _traced(lambda: adc.pq_scan(lut, codes, valid, k=40), adc.pq_scan, "lut_stationary_rows_kernel")
    assert sum("lut_stationary_rows_kernel" in n for n in names) == 1, names
    assert not any("merge_partials" in n or "adc_slot_warps_kernel" in n for n in names), names
    want = adc.pq_scan_plain(lut, codes, valid, k=40)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _dense_case(dev, seed, W, TQ, TV, M, pattern, dup=False):
    """Expanded LUTs (NaN on the slots past ``n_live``: a read of one would
    show), codes (rows repeated in pairs for ties), a mask and ``n_live``."""
    table, lut_idx, codes, valid = _adc_case(dev, seed, W, TQ, TV, M, U=97)
    luts = table[lut_idx.long()].contiguous()
    n_live = _n_live(dev, W, TQ, pattern)
    luts[torch.arange(TQ, device=dev)[None, :] >= n_live[:, None]] = float("nan")
    if dup:
        codes = codes[:, ::2].repeat_interleave(2, dim=1)[:, :TV].contiguous()
    return luts, codes, valid, n_live


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["zero", "one", "ragged", "full"])
@pytest.mark.parametrize(
    "W,TQ,TV,M,k",
    [(64, 64, 64, 8, 40), (16, 64, 300, 16, 10), (5, 3, 37, 5, 10), (4, 100, 1100, 8, 64),
     (3, 16, 2048, 8, 40), (2, 1, 5000, 12, 33)],
)
def test_dense_adc_live_slots(dev, pattern, W, TQ, TV, M, k):
    """``workunit_pq_scan`` with ``n_live``: bit-equal to the plain version
    (ties included), every slot past the count (NEG_INF, -1) and its LUT
    (NaN) never read; shapes off the 16-byte grid, slots over several warps,
    rows split over blocks."""
    luts, codes, valid, n_live = _dense_case(dev, W + TV + k, W, TQ, TV, M, pattern, dup=True)
    got = adc.workunit_pq_scan(luts, codes, valid, k=k, n_live=n_live)
    want = adc.workunit_pq_scan_plain(luts, codes, valid, k=k, n_live=n_live)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    dead = torch.arange(TQ, device=dev)[None, :] >= n_live[:, None]
    assert (got[1][dead] == -1).all() and (got[0][dead] == -3.4e38).all()


@pytest.mark.cuda
@pytest.mark.parametrize("W,TQ,TV,k", [(4, 64, 4096, 40), (16, 128, 32768, 40), (2, 16, 4096, MAX_K)])
def test_dense_adc_long_unit_is_one_launch(dev, W, TQ, TV, k):
    """A long unit splits over blocks (the C entry's launch shape, equal to
    the CPU tests' copy in ``torch_adc_shape``) and the last block merges
    their lists in the same launch: the profiler sees one
    ``adc_slot_warps_kernel`` and no merge kernel; the result is bit-equal
    to the plain version."""
    from torch_adc_shape import launch_shape

    for w, tq, tv, m in ((W, TQ, TV, 8), (2048, 64, 64, 8), (8, 64, 4096, 16), (1, 1, 100_000, 8),
                         (3, 16, 2048, 181), (128, 64, 256, 100)):
        assert adc.launch_shape(w, tq, tv, m, k) == launch_shape(w, tq, tv, m, k), (w, tq, tv, m)
    assert adc.launch_shape(W, TQ, TV, 8, k)[4] > 1
    luts, codes, valid, n_live = _dense_case(dev, TV + k, W, TQ, TV, 8, "ragged")
    adc.workunit_pq_scan(luts, codes, valid, k=k, n_live=n_live)  # built and warm
    torch.cuda.synchronize()
    got, names = _traced(lambda: adc.workunit_pq_scan(luts, codes, valid, k=k, n_live=n_live),
                         adc.workunit_pq_scan, "adc_slot_warps_kernel")
    assert sum("adc_slot_warps_kernel" in n for n in names) == 1, names
    assert not any("merge_partials" in n for n in names), names
    want = adc.workunit_pq_scan_plain(luts, codes, valid, k=k, n_live=n_live)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_pq_engine_names_the_kernel_limits(dev):
    """refine_factor=8 at k=10 asks the ADC kernel for k′ = 80: the resident
    scan runs it in two passes a bucket that holds 80 rows, and the search
    agrees with the same index searched on the CPU; so does the default
    k′ = 40, through the resident-LUT kernel and the re-rank grid."""
    kg = kg_style(n=20_000, d=16, queries_per_split=60, seed=0)
    wl = kg.splits[1]
    index = HQIIndex.build(kg.db, kg.splits[0], HQIConfig(scan_mode="pq", pq_m=4), device=dev)
    cpu = HQIIndex.from_state(index.to_state(), device="cpu")
    for rf in (8, 4):
        n0 = adc.workunit_pq_scan_streamed.launches
        r0 = fused_knn_db_stationary.launches
        a = index.search(wl, nprobe=8, refine_factor=rf)
        assert adc.workunit_pq_scan_streamed.launches > n0 and fused_knn_db_stationary.launches > r0
        b = cpu.search(wl, nprobe=8, refine_factor=rf)
        torch.testing.assert_close(torch.from_numpy(a.scores), torch.from_numpy(b.scores),
                                   rtol=1e-4, atol=1e-4)
        for ra, rb in zip(a.ids, b.ids):
            assert set(ra[ra >= 0].tolist()) == set(rb[rb >= 0].tolist())


@pytest.mark.cuda
@pytest.mark.parametrize("scan_mode", ["f32", "pq"])
@pytest.mark.parametrize("layout", ["segmented", "dense"])
def test_sharded_engine_on_the_card(dev, scan_mode, layout):
    """A two-rank mesh on the card (``HQIConfig.mesh``, both ranks on one
    device) answers bit-equal to ``mesh=None``, f32 and PQ, both merge
    layouts; its ranks' units launch the same kernels the same number of
    times as the single-device search."""
    from repro_torch.launch.mesh import make_test_mesh

    kg = kg_style(n=20_000, d=16, queries_per_split=60, seed=0)
    wl = kg.splits[1]
    cfg = HQIConfig() if scan_mode == "f32" else HQIConfig(scan_mode="pq", pq_m=4)
    cfg.plan.merge_layout = layout
    index = HQIIndex.build(kg.db, kg.splits[0], cfg, device=dev)
    grids = (fused_knn, fused_knn_db_stationary, adc.workunit_pq_scan_streamed, adc.workunit_pq_scan)
    got = {}
    for side, mesh in (("single", None), ("sharded", make_test_mesh((2,), ("model",), device="cuda"))):
        index.cfg.mesh = mesh
        n0 = [g.launches for g in grids]
        got[side] = (index.search(wl, nprobe=8), [g.launches - n for g, n in zip(grids, n0)])
    index.cfg.mesh = None
    (a, la), (b, lb) = got["single"], got["sharded"]
    assert b.shard_stats is not None and b.shard_stats.n_shards == 2
    assert la == lb and sum(lb) > 0
    assert np.array_equal(a.scores, b.scores) and np.array_equal(a.ids, b.ids)


# --------------------------------------------------------- flash attention


def _attn_case(dev, seed, b, s, hq, hkv, dh, dtype, t=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    t = s if t is None else t
    q = torch.randn((b, s, hq, dh), generator=g, device=dev).to(dtype)
    k = torch.randn((b, t, hkv, dh), generator=g, device=dev).to(dtype)
    v = torch.randn((b, t, hkv, dh), generator=g, device=dev).to(dtype)
    return q, k, v


ATTN = [
    # b, s, t, hq, hkv, dh, causal, window
    (1, 1024, 1024, 32, 16, 128, True, 0),  # gemma3 heads, global layer
    (1, 1100, 1100, 32, 16, 128, True, 1024),  # gemma3 heads, local layer
    (1, 600, 600, 36, 36, 64, True, 0),  # minicpm heads: GQA group 1, dh 64
    (1, 700, 700, 64, 8, 128, True, 100),  # qwen3 heads: group 8
    (2, 100, 100, 4, 2, 64, True, 0),  # group 2, S off the 64-row tile
    (1, 1000, 1000, 4, 2, 128, True, 16),  # window below the tile, S >> window
    (2, 77, 77, 4, 2, 64, False, 0),  # not causal, ragged
    (1, 130, 130, 4, 1, 64, False, 24),  # not causal with a window
    (1, 40, 100, 4, 2, 64, True, 0),  # S < T (query positions left-aligned)
    (1, 90, 30, 4, 2, 32, False, 8),  # S > T: late rows keep no key and return 0
    (1, 33, 33, 2, 1, 16, True, 0),  # dh 16, padded to the 32-wide build
    (1, 70, 70, 2, 2, 200, True, 0),  # dh 200, padded to 256
    (1, 65, 65, 2, 1, 256, True, 3),  # the widest dh the tiles hold
    (1, 300, 300, 4, 2, 80, True, 0),  # zamba2's dh 80, padded to the 128-wide build
    (2, 150, 150, 4, 2, 36, True, 50),  # dh not a multiple of 8: bf16 pads it to 40 on the card
    (1, 8192, 8192, 4, 4, 128, True, 0),  # 64 KV tiles per late block: the ring wraps many times
    (1, 8192, 8192, 4, 4, 128, True, 1000),  # the same under a window (tiles skipped by band)
    (1, 520, 520, 8, 1, 128, True, 0),  # a GQA group of 8: eight query heads read one KV head
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.bfloat16, 2e-2, 2e-3), (torch.float32, 1e-4, 1e-4)],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("b,s,t,hq,hkv,dh,causal,window", ATTN)
def test_flash_attention_matches_plain(dev, dtype, rtol, atol, b, s, t, hq, hkv, dh, causal, window):
    """The kernel against its plain version on the same card inputs: one
    launch, no plain call, finite output (no NaN from fully masked tiles).
    In f32 both compute in f32 and differ only in the order of the sums. In
    bf16 the tensor-core kernel rounds P to bf16 before P·V (up to 2^-9 of
    each p, ~1e-3 of |o|) and adds P's bf16 remainder on tiles whose rows
    have few effective keys, where one rounding could move a near-zero
    output past atol; with the outputs' own bf16 rounding (one ulp, 2^-7 of
    |o|, which rtol covers) the relative error stays within rtol/2."""
    q, k, v = _attn_case(dev, s + dh, b, s, hq, hkv, dh, dtype, t)
    n0, c0 = fa.flash_attention.launches, fa.flash_attention_plain.calls
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n0 + 1 and fa.flash_attention_plain.calls == c0
    assert got.dtype == dtype and got.shape == q.shape and torch.isfinite(got).all()
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
    diff = torch.linalg.vector_norm(got.float() - want.float())
    assert diff <= rtol / 2 * torch.linalg.vector_norm(want.float())


def _attn_close(got, want):
    """ATTN_TOL of chip_smoke.py for the output's type: elementwise rtol/atol
    and a limit on the relative error of the whole output."""
    rtol, atol, rel = {torch.bfloat16: (2e-2, 2e-3, 1e-2), torch.float32: (1e-4, 1e-4, 5e-5)}[got.dtype]
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
    diff = torch.linalg.vector_norm(got.float() - want.float())
    assert diff <= rel * torch.linalg.vector_norm(want.float())


WIDE_ATTN = [
    # b, s, t, hq, hkv, dh, causal, window: for each width the issue names, a
    # windowed S = T case and a global one with S < T (left-aligned rows)
    *[c for dh in (264, 288, 384, 512, 520, 1024, 2100)
      for c in ((1, 1100, 1100, 4, 2, dh, True, 1024), (1, 90, 200, 2, 1, dh, True, 0))],
    (2, 70, 70, 2, 2, 640, False, 0),  # not causal, two batches
    (1, 90, 30, 2, 1, 384, False, 8),  # S > T: late rows keep no key and return 0
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("b,s,t,hq,hkv,dh,causal,window", WIDE_ATTN)
def test_flash_attention_wide_head(dev, dtype, b, s, t, hq, hkv, dh, causal, window):
    """Head widths past 256 take the wide kernels (bf16 up to 512: wgmma at
    DH 384 / 512 in two column slices; otherwise the sliced CUDA-core
    kernel): one launch, none of the tiled kernels, within ATTN_TOL of the
    plain version."""
    q, k, v = _attn_case(dev, s + dh, b, s, hq, hkv, dh, dtype, t)
    n0, w0 = fa.flash_attention.launches, fa.flash_attention_wide.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention_wide.launches == w0 + 1 and fa.flash_attention.launches == n0
    assert got.dtype == dtype and got.shape == q.shape
    _attn_close(got, fa.flash_attention_plain(q, k, v, causal=causal, window=window))


@pytest.mark.cuda
def test_flash_attention_misaligned_bf16_base(dev):
    """Contiguous bf16 views whose bases are not 16-byte aligned (TMA needs
    that) run: the wrapper copies them, and the result matches the plain
    version."""
    b, s, hq, hkv, dh = 1, 70, 4, 2, 64
    n_q, n_kv = b * s * hq * dh, b * s * hkv * dh
    g = torch.Generator(device=dev).manual_seed(5)
    flat = torch.randn(1 + n_q + 2 * n_kv, generator=g, device=dev).to(torch.bfloat16)
    q = flat[1:1 + n_q].view(b, s, hq, dh)
    k = flat[1 + n_q:1 + n_q + n_kv].view(b, s, hkv, dh)
    v = flat[1 + n_q + n_kv:].view(b, s, hkv, dh)
    assert all(x.is_contiguous() and x.data_ptr() % 16 for x in (q, k, v))
    n0 = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, window=20)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n0 + 1
    want = fa.flash_attention_plain(q, k, v, window=20)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-3)


@pytest.mark.cuda
def test_flash_attention_limits(dev):
    """dh beyond the tiles takes the wide kernels (one launch, within
    ATTN_TOL of the plain version); a non-contiguous input raises before
    launch."""
    n0, w0 = fa.flash_attention.launches, fa.flash_attention_wide.launches
    q, k, v = _attn_case(dev, 1, 1, 16, 2, 1, 257, torch.bfloat16)
    got = fa.flash_attention(q, k, v)
    assert fa.flash_attention_wide.launches == w0 + 1
    _attn_close(got, fa.flash_attention_plain(q, k, v))
    q, k, v = _attn_case(dev, 2, 1, 16, 2, 1, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    assert fa.flash_attention.launches == n0


@pytest.mark.cuda
def test_reduced_lm_serves_alike_on_card_and_cpu(dev):
    """Reduced gemma3 in f32, the same weights on both devices: prefill and
    decode logits within 2e-3, the SlotServer's tokens equal, and every
    prefill layer launched the kernel on the card. The steps are
    ``chip_smoke.py``'s card-against-CPU phase, run here as it runs there."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    rec = {}
    smoke.phase_lm_card_vs_cpu(rec)
    assert rec["lm_card_vs_cpu"]["max_abs_logit_err"] <= 2e-3


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


# chip_smoke.py's BWD_SMALL (phase T(a)) up to dh 200, and two more of the split pair's:
# b, s, t, hq, hkv, dh, causal, window
BWD = [
    (2, 77, 77, 4, 2, 16, True, 0),  # ragged S, dh 16 (the 32-wide build)
    (2, 50, 50, 4, 4, 16, False, 0),  # not causal
    (1, 90, 90, 4, 2, 16, True, 7),  # a window below the tile
    (1, 40, 40, 8, 1, 16, True, 0),  # a GQA group of 8 on one KV head
    (1, 30, 60, 4, 2, 16, True, 0),  # S < T
    (1, 90, 30, 4, 2, 16, False, 8),  # S > T: rows 37.. keep no key
    (1, 300, 300, 4, 2, 64, True, 100),
    (2, 200, 200, 4, 2, 128, True, 0),
    (1, 130, 130, 2, 1, 200, True, 0),  # f32: the 256-wide build in two column slices
    (1, 130, 130, 4, 2, 136, True, 0),  # bf16: the split wgmma pair at DH 256, ragged S, GQA 2
    (1, 100, 60, 4, 2, 256, True, 0),  # S > T, causal, a full DH 256
]


def _bwd_check(dev, dtype, tol, b, s, t, hq, hkv, dh, causal, window):
    """The backward kernels on the forward kernel's o and lse and a random
    dO against the plain backward, which recomputes its own statistics (so
    the kernel's lse is checked too): one launch, no plain call, each of dq,
    dk, dv finite and within ``tol`` of the plain version's norm. Returns
    the kernels' gradients."""
    q, k, v = _attn_case(dev, s + dh, b, s, hq, hkv, dh, dtype, t)
    o, lse = fa.flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
    do = torch.randn_like(q)
    n0, c0 = fa.flash_attention_backward.launches, fa.flash_attention_backward_plain.calls
    got = fa.flash_attention_backward(q, k, v, o, do, lse, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention_backward.launches == n0 + 1 and fa.flash_attention_backward_plain.calls == c0
    want = fa.flash_attention_backward_plain(q, k, v, o, do, causal=causal, window=window)
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == x.shape and torch.isfinite(g).all()
        assert torch.linalg.vector_norm(g.float() - w.float()) <= tol * torch.linalg.vector_norm(w.float())
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)], ids=["bf16", "f32"])
@pytest.mark.parametrize("b,s,t,hq,hkv,dh,causal,window", BWD)
def test_flash_attention_backward_matches_plain(dev, dtype, tol, b, s, t, hq, hkv, dh, causal, window):
    """The backward kernels (bf16 up to dh 128: the wgmma pair, past it the
    split wgmma pair; f32 the 3xTF32 tensor-core pair at DH 32, 64, 128 and
    256) against their plain version within ``chip_smoke.BWD_TOL`` (f32:
    the order of the sums and three TF32 passes, ~2^-21 a product; bf16:
    also P and dS rounded to bf16 before their tensor-core products, and one
    rounding of each output); rows that keep no key get dq = 0."""
    got = _bwd_check(dev, dtype, tol, b, s, t, hq, hkv, dh, causal, window)
    if s > t and not causal and window:
        assert torch.all(got[0][:, t + window - 1:] == 0)


# past dh 256 (bf16 to 512 the split wgmma pair, f32 and wider bf16 the
# wide pair): b, s, t, hq, hkv, dh, causal, window
WIDE_BWD = [
    (1, 64, 64, 2, 1, 264, True, 0),  # just past the 3xTF32 pair's 256; bf16 at DH 384
    (1, 130, 130, 4, 2, 320, True, 0),  # GQA 2, ragged S
    (1, 90, 200, 2, 1, 320, True, 0),  # S < T
    (1, 90, 30, 2, 1, 320, False, 8),  # S > T: rows 37.. keep no key
    (1, 150, 150, 4, 2, 512, True, 50),  # a window; bf16 at DH 512 in two dK/dV slices
    (1, 90, 30, 2, 1, 384, False, 8),  # S > T at a full DH 384
    (2, 77, 77, 4, 2, 384, True, 0),  # two batches, ragged S
    (1, 130, 130, 4, 2, 520, True, 0),  # past 512: the wide pair in both types, two slices
    (1, 100, 100, 2, 1, 640, True, 30),  # a window; f32 streams its dK/dV stationary rows
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)], ids=["bf16", "f32"])
@pytest.mark.parametrize("b,s,t,hq,hkv,dh,causal,window", WIDE_BWD)
def test_flash_attention_backward_wide_head(dev, dtype, tol, b, s, t, hq, hkv, dh, causal, window):
    """Head widths past 256: bf16 up to 512 on the split wgmma pair (P and
    dS rounded to bf16), f32 and wider bf16 on the wide CUDA-core pair (S
    and dP once a tile for a slice of up to 512 columns, all sums f32),
    within ``chip_smoke.BWD_TOL`` of the plain version."""
    got = _bwd_check(dev, dtype, tol, b, s, t, hq, hkv, dh, causal, window)
    if s > t and not causal and window:
        assert torch.all(got[0][:, t + window - 1:] == 0)


# f32 sequences whose sums over keys (queries) run thousands of k8 steps on
# the 3xTF32 pair: b, s, hq, hkv, dh (causal, S = T)
LONG_F32 = [(1, 16384, 4, 4, 64), (1, 8192, 4, 2, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,hq,hkv,dh", LONG_F32)
def test_flash_attention_backward_f32_long_sequence(dev, b, s, hq, hkv, dh):
    """The 3xTF32 pair at T 16384 (dh 64) and 8192 (dh 256): each gradient
    within ``chip_smoke.BWD_TOL[4]`` of the plain version. Its accumulating
    products add each k8 step's three TF32 products to their sums by f32
    adds; chained in the tensor core's accumulator instead, dK's error grew
    with T past the limit (1.7e-4 at 16384)."""
    _bwd_check(dev, torch.float32, 1e-4, b, s, s, hq, hkv, dh, True, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["q", "do"])
@pytest.mark.parametrize("dh", [16, 64, 128, 200])
def test_flash_attention_backward_f32_keeps_nan(dev, where, dh):
    """A NaN in q or in dO reaches the 3xTF32 pair's gradients (DH 32, 64,
    128, 256) exactly where it reaches the plain version's: every pair is
    kept (not causal, no window), so every tile is computed and the NaN sets
    do not depend on tiling. The NaN is the GPU's canonical one: its hi
    rounds to -0, and the split keeps it NaN in lo = x - hi (rounding lo as
    hi made every product of it a zero term). The rest within
    ``chip_smoke.BWD_TOL[4]``."""
    b, s, hq, hkv = 2, 100, 4, 2
    q, k, v = _attn_case(dev, dh + 11, b, s, hq, hkv, dh, torch.float32)
    do = torch.randn_like(q)
    # the GPU's canonical NaN (what a diverging step's arithmetic writes), whose bits carry into the sign
    # when hi is rounded
    (q if where == "q" else do)[1, 37, 3, 5] = torch.tensor(0x7FFFFFFF, dtype=torch.int32).view(torch.float32)
    o, lse = fa.flash_attention_plain(q, k, v, causal=False, return_lse=True)
    n0 = fa.flash_attention_backward.launches
    got = fa.flash_attention_backward(q, k, v, o, do, lse, causal=False)
    torch.cuda.synchronize()
    assert fa.flash_attention_backward.launches == n0 + 1
    want = fa.flash_attention_backward_plain(q, k, v, o, do, lse, causal=False)
    for g, w in zip(got, want):
        nan = torch.isnan(w)
        assert nan.any() and torch.equal(torch.isnan(g), nan)
        assert torch.linalg.vector_norm(g[~nan] - w[~nan]) <= 1e-4 * torch.linalg.vector_norm(w[~nan])


@pytest.mark.cuda
def test_flash_attention_backward_misaligned_bf16(dev):
    """bf16 operands off a 16-byte boundary (TMA wants aligned bases): the
    wrapper copies them and the wgmma pair gives the same gradients."""
    b, s, hq, hkv, dh = 1, 100, 4, 2, 64
    g = torch.Generator(device=dev).manual_seed(5)
    flat = torch.randn(b * s * hq * dh + 1, generator=g, device=dev).to(torch.bfloat16)
    q = flat[1:].view(b, s, hq, dh)
    _, k, v = _attn_case(dev, 6, b, s, hq, hkv, dh, torch.bfloat16)
    assert q.data_ptr() % 16 != 0 and q.is_contiguous()
    o, lse = fa.flash_attention(q.clone(), k, v, window=30, return_lse=True)
    do = torch.randn_like(o)
    got = fa.flash_attention_backward(q, k, v, o, do, lse, window=30)
    want = fa.flash_attention_backward_plain(q, k, v, o, do, window=30)
    for gr, w in zip(got, want):
        assert torch.linalg.vector_norm(gr.float() - w.float()) <= 2e-2 * torch.linalg.vector_norm(w.float())


@pytest.mark.cuda
def test_flash_attention_backward_misaligned_bf16_wide(dev):
    """bf16 operands off a 16-byte boundary at dh 320 (the split wgmma
    pair): the wrapper copies them and the gradients hold."""
    b, s, hq, hkv, dh = 1, 100, 4, 2, 320
    g = torch.Generator(device=dev).manual_seed(6)
    flat = torch.randn(b * s * hq * dh + 1, generator=g, device=dev).to(torch.bfloat16)
    q = flat[1:].view(b, s, hq, dh)
    _, k, v = _attn_case(dev, 7, b, s, hq, hkv, dh, torch.bfloat16)
    assert q.data_ptr() % 16 != 0 and q.is_contiguous()
    o, lse = fa.flash_attention(q.clone(), k, v, window=30, return_lse=True)
    do = torch.randn_like(o)
    got = fa.flash_attention_backward(q, k, v, o, do, lse, window=30)
    want = fa.flash_attention_backward_plain(q, k, v, o, do, window=30)
    for gr, w in zip(got, want):
        assert torch.linalg.vector_norm(gr.float() - w.float()) <= 2e-2 * torch.linalg.vector_norm(w.float())


@pytest.mark.cuda
def test_backward_plan_matches_the_c_entry(dev):
    """``flash_attention.backward_plan`` (which the CPU tests check and the
    wrapper pads by) equals the C entry's ``flash_attention_bwd_plan`` for
    every dh up to 1,100 in both types: route, width, slices, shared bytes,
    threads and the wide pair's staging."""
    import ctypes

    from repro_torch.kernels import _build

    lib = _build.library("flash_attention_bwd")
    out = (ctypes.c_int * 9)()
    routes = {"wgmma": 0, "wgmma_split": 1, "tf32x3": 2, "wide": 3}
    for es in (2, 4):
        for dh in range(1, 1101):
            p = fa.backward_plan(dh, es)
            assert lib.flash_attention_bwd_plan(p["dp"], int(es == 2), ctypes.cast(out, ctypes.c_void_p)) == 0
            assert list(out) == [routes[p["route"]], p["width"], p["dq_slices"], p["dkdv_slices"], p["dq_smem"],
                                 p["dkdv_smem"], p["threads"], *p["stationary"]], (es, dh)


@pytest.mark.cuda
def test_flash_attention_backward_needs_lse_on_the_card(dev):
    """The kernels read the forward's lse and never recompute the
    statistics: without it the call raises before any launch."""
    q, k, v = _attn_case(dev, 1, 1, 64, 2, 1, 64, torch.bfloat16)
    n0 = fa.flash_attention_backward.launches
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_backward(q, k, v, q, q)
    assert fa.flash_attention_backward.launches == n0


# the forward's lse: (b, s, t, hq, hkv, dh, causal, window), tiled and wide
LSE_CASES = [
    (1, 300, 300, 36, 36, 64, True, 0),  # minicpm heads
    (1, 600, 600, 32, 16, 128, True, 100),  # gemma3 heads, a window
    (1, 90, 30, 4, 2, 32, False, 8),  # S > T: rows that keep no key (NEG_INF)
    (1, 70, 70, 2, 2, 200, True, 0),
    (1, 130, 200, 4, 2, 320, True, 0),  # wide: bf16 on wgmma at DH 384, f32 sliced
    (1, 100, 100, 2, 1, 640, True, 30),  # wide: both types sliced
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 2e-3), (torch.float32, 1e-4)], ids=["bf16", "f32"])
@pytest.mark.parametrize("b,s,t,hq,hkv,dh,causal,window", LSE_CASES)
def test_forward_lse_leaves_the_output_unchanged(dev, dtype, atol, b, s, t, hq, hkv, dh, causal, window):
    """The forward asked for lse gives the output bit for bit as serving
    does (the same launches), and its lse matches the plain version's: each
    row's m + log l in the natural log of the scaled logits (the bf16
    kernel's log2-unit statistics converted back), NEG_INF where a row keeps
    no key."""
    q, k, v = _attn_case(dev, s + dh, b, s, hq, hkv, dh, dtype, t)
    o = fa.flash_attention(q, k, v, causal=causal, window=window)
    o_lse, lse = fa.flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(o, o_lse)
    assert lse.dtype == torch.float32 and lse.shape == (b, hq, s)
    _, want = fa.flash_attention_plain(q, k, v, causal=causal, window=window, return_lse=True)
    torch.testing.assert_close(lse, want, rtol=1e-5, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [32, 36, 64, 128, 200, 256])
def test_flash_attention_f32_forward_launch_name(dev, dh):
    """An f32 forward up to dh 256 (every compiled width; dh 36 padded to 40,
    200 to DH 256) launches ``flash_fwd_tf32x3_kernel`` once, by name, and
    no other attention kernel (not the CUDA-core ``flash_fwd_kernel`` it
    replaced), within ATTN_TOL[4] of the plain version and its lse within
    LSE_TOL[4] (a window, GQA 2, S off the block's 64 rows)."""
    q, k, v = _attn_case(dev, dh + 17, 1, 300, 4, 2, dh, torch.float32)
    (got, lse), names = _traced(lambda: fa.flash_attention(q, k, v, window=100, return_lse=True), fa.flash_attention,
                                "flash_fwd_tf32x3_kernel")
    flash = [n for n in names if "flash_" in n]
    assert len(flash) == 1 and "flash_fwd_tf32x3_kernel" in flash[0], names
    want, want_lse = fa.flash_attention_plain(q, k, v, window=100, return_lse=True)
    _attn_close(got, want)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-4)


# f32 forward sequences whose sums over keys run thousands of k8 steps on the
# 3xTF32 kernel: b, s, hq, hkv, dh (causal, S = T)
LONG_F32_FWD = [(1, 16384, 4, 4, 64), (1, 8192, 4, 2, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,hq,hkv,dh", LONG_F32_FWD)
def test_flash_attention_f32_forward_long_sequence(dev, b, s, hq, hkv, dh):
    """The 3xTF32 forward at T 16384 (dh 64) and 8192 (dh 256): o within
    ATTN_TOL[4] and lse within LSE_TOL[4] of the plain version. Each key
    tile's P·V is summed from zero and added to the running O in f32; chained
    through the tensor core's accumulator, whose additions do not round to
    nearest, such sums drifted with T in the backward."""
    q, k, v = _attn_case(dev, s + dh, b, s, hq, hkv, dh, torch.float32)
    n0 = fa.flash_attention.launches
    got, lse = fa.flash_attention(q, k, v, return_lse=True)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n0 + 1
    want, want_lse = fa.flash_attention_plain(q, k, v, return_lse=True)
    _attn_close(got, want)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["q", "v"])
@pytest.mark.parametrize("dh", [32, 64, 128, 200])
def test_flash_attention_f32_forward_keeps_nan(dev, where, dh):
    """A NaN in q or in v reaches the 3xTF32 forward's output (DH 32, 64,
    128, 256) exactly where it reaches the plain version's: a q element its
    row, a v element its column in every row of the query heads reading
    that KV head. Every pair is kept (not causal, no window), so every tile
    is computed and the NaN sets do not depend on tiling. The NaN is the
    GPU's canonical one, whose hi rounds to -0: the split keeps it NaN in lo
    = x - hi. The rest within ATTN_TOL[4]."""
    b, s, hq, hkv = 2, 100, 4, 2
    q, k, v = _attn_case(dev, dh + 13, b, s, hq, hkv, dh, torch.float32)
    (q if where == "q" else v)[1, 37, 1, 5] = torch.tensor(0x7FFFFFFF, dtype=torch.int32).view(torch.float32)
    n0 = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n0 + 1
    want = fa.flash_attention_plain(q, k, v, causal=False)
    nan = torch.isnan(want)
    assert nan.any() and torch.equal(torch.isnan(got), nan)
    torch.testing.assert_close(got[~nan], want[~nan], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_flash_attention_misaligned_f32_base(dev):
    """Contiguous f32 views whose bases are not 16-byte aligned (the 3xTF32
    kernel reads 16-byte rows by cp.async) run: the wrapper copies them, and
    the result matches the plain version within ATTN_TOL[4]."""
    b, s, hq, hkv, dh = 1, 70, 4, 2, 64
    n_q, n_kv = b * s * hq * dh, b * s * hkv * dh
    g = torch.Generator(device=dev).manual_seed(8)
    flat = torch.randn(1 + n_q + 2 * n_kv, generator=g, device=dev)
    q = flat[1:1 + n_q].view(b, s, hq, dh)
    k = flat[1 + n_q:1 + n_q + n_kv].view(b, s, hkv, dh)
    v = flat[1 + n_q + n_kv:].view(b, s, hkv, dh)
    assert all(x.is_contiguous() and x.data_ptr() % 16 for x in (q, k, v))
    n0 = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, window=20)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n0 + 1
    _attn_close(got, fa.flash_attention_plain(q, k, v, window=20))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,dh,kernels", [
    (torch.bfloat16, 64, ("bwd_dq_wgmma_kernel", "bwd_dkdv_wgmma_kernel")),
    (torch.bfloat16, 128, ("bwd_dq_wgmma_kernel", "bwd_dkdv_wgmma_kernel")),
    (torch.bfloat16, 200, ("bwd_dq_wgmma_split_kernel", "bwd_dkdv_wgmma_split_kernel")),
    (torch.float32, 64, ("bwd_dq_tf32x3_kernel", "bwd_dkdv_tf32x3_kernel")),
    (torch.bfloat16, 320, ("bwd_dq_wgmma_split_kernel", "bwd_dkdv_wgmma_split_kernel")),
    (torch.float32, 320, ("bwd_dq_wide_kernel", "bwd_dkdv_wide_kernel")),
    (torch.bfloat16, 520, ("bwd_dq_wide_kernel", "bwd_dkdv_wide_kernel")),
    (torch.float32, 16, ("bwd_dq_tf32x3_kernel", "bwd_dkdv_tf32x3_kernel")),
    (torch.float32, 128, ("bwd_dq_tf32x3_kernel", "bwd_dkdv_tf32x3_kernel")),
    (torch.float32, 256, ("bwd_dq_tf32x3_kernel", "bwd_dkdv_tf32x3_kernel")),
], ids=["bf16-dh64", "bf16-dh128", "bf16-dh200", "f32-dh64", "bf16-dh320", "f32-dh320", "bf16-dh520", "f32-dh16",
        "f32-dh128", "f32-dh256"])
def test_flash_attention_backward_launch_names(dev, dtype, dh, kernels):
    """A traced call launches the two kernels of its design, by name, and
    no backward kernel of another design (chip_smoke.py's ``device_ms``
    finds them by the ``bwd_dq`` and ``bwd_dkdv`` in their names): f32 up
    to dh 256 the 3xTF32 pair at every compiled width, never the wide
    pair."""
    q, k, v = _attn_case(dev, 3, 1, 256, 4, 2, dh, dtype)
    o, lse = fa.flash_attention(q, k, v, return_lse=True)
    do = torch.randn_like(q)
    _, names = _traced(lambda: fa.flash_attention_backward(q, k, v, o, do, lse), fa.flash_attention_backward,
                       kernels[0])
    for kernel in kernels:
        assert sum(kernel in n for n in names) == 1, (kernel, names)
    assert all(any(kernel in n for kernel in kernels) for n in names if "bwd_" in n), names


@pytest.mark.cuda
def test_training_card_equals_cpu(dev, tmp_path):
    """``chip_smoke.py``'s phase T(c): the reduced minicpm in f32 with the
    same weights and batches on the card and the CPU (gradients, 3 steps'
    losses and parameters within 1e-4), then a restarted ``TrainLoop`` on
    the card against an uninterrupted one."""
    rec = {}
    _smoke().phase_train_card_vs_cpu(rec, str(tmp_path))
    assert rec["train_card_vs_cpu"]["param_max_abs_err"] <= 1e-4


@pytest.mark.cuda
def test_delta_store_pq_scan_card_equals_cpu(dev, monkeypatch):
    """The delta store's compressed scan on the card against the same store
    on the CPU: the ADC dispatch (kernel 4, ``n_live`` = the flush
    templates' ragged query counts) is bit-equal to the plain version's, and
    the re-ranked answers agree (scores within 1e-4, equal id sets)."""
    import numpy as np

    from repro_torch.core.pq import train_pq
    from repro_torch.kernels import ops
    from repro_torch.service import DeltaStore

    kg = kg_style(n=6000, d=32, queries_per_split=200, seed=0)
    db, wl = kg.db, kg.splits[1]
    cb = train_pq(db.vectors, 4, metric=db.metric, device="cpu")
    rng = np.random.default_rng(4)
    src = rng.integers(0, db.n, 3000)
    vecs = db.vectors[src] + 0.01 * rng.normal(size=(3000, db.d)).astype(np.float32)
    cols = {name: c.values[src] for name, c in db.columns.items()}
    nulls = {name: c.null_mask[src] for name, c in db.columns.items() if c.kind != "setcat"}
    dead = rng.choice(np.arange(db.n, db.n + 3000), 300, replace=False)
    stores = [DeltaStore(db, first_id=db.n, pq=cb, device=d) for d in (dev, "cpu")]
    for s in stores:
        s.insert(vecs, cols, nulls)
        for gid in dead:
            s.delete(int(gid))
    seen = []
    real = ops.workunit_pq_topk

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.append((kw["n_live"].cpu(), out[0].cpu(), out[1].cpu()))
        return out

    monkeypatch.setattr(ops, "workunit_pq_topk", spy)
    n0 = adc.workunit_pq_scan.launches
    a = [t.cpu().numpy() for t in stores[0].scan(wl, pq_threshold=100, refine_factor=4)]
    assert adc.workunit_pq_scan.launches == n0 + 1
    b = [t.numpy() for t in stores[1].scan(wl, pq_threshold=100, refine_factor=4)]
    (nl_a, sa, ia), (nl_b, sb, ib) = seen
    assert torch.equal(nl_a, nl_b) and len(set(nl_a.tolist())) > 1
    assert torch.equal(sa, sb) and torch.equal(ia, ib)
    np.testing.assert_allclose(np.where(np.isfinite(a[0]), a[0], -1e30),
                               np.where(np.isfinite(b[0]), b[0], -1e30), rtol=1e-4, atol=1e-4)
    for r in range(wl.m):
        assert set(a[1][r][a[1][r] >= 0].tolist()) == set(b[1][r][b[1][r] >= 0].tolist()), r


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.cuda
def test_service_streams_alike_on_card_and_cpu(dev, tmp_path):
    """A small service stream on the card and on a CPU reload of the same
    index, through writes that put the delta past the PQ threshold, a
    refresh() and an overload burst, then the card's store opened on the
    CPU: ``chip_smoke.py``'s S2 phase, run here at 20k rows."""
    kg = kg_style(n=20_000, d=64, seed=0)
    index = HQIIndex.build(kg.db, kg.splits[0], HQIConfig(), device=dev)
    rec = {}
    _smoke().phase_service_card_vs_cpu(rec, kg, index, inserts=5120, burst_depth=512, out_dir=str(tmp_path))
    row = rec["service_card_vs_cpu"]
    assert row["burst"]["degraded_queries"] > 0
    assert row["store_opened_on_cpu"]["wal_tail_records"] == 2


@pytest.mark.cuda
def test_store_durability_and_evolution_on_the_card(dev, tmp_path):
    """``chip_smoke.py``'s S3 at 20k rows: a store round trip on the card
    (writes through the WAL, a crash, ``open_service`` onto the card with
    the same live ids and answers), a compaction whose reopen replays
    nothing, a tune beside a thread of queries and its rollback, and the
    chaos harness on the card."""
    kg = kg_style(n=20_000, d=64, queries_per_split=2_000, seed=0)
    index = HQIIndex.build(kg.db, kg.splits[0], HQIConfig(), device=dev)
    index.attach_pq(train_pq(kg.db.vectors, 8, metric=kg.db.metric, seed=0, device=dev))
    rec = {}
    _smoke().phase_store(rec, index, kg, kg.splits[1], str(tmp_path), inserts=(40, 128),
                         deletes=(8, 64), queries=500, shift_queries=1_000)
    row = rec["store"]
    assert row["writes"]["wal_records"] == 48 and row["writes"]["fsyncs"] >= 48
    assert row["recovery"]["replayed_records"] == 48 and row["recovery"]["replayed_rows"] == 5120
    assert row["recovery"]["max_score_diff"] <= 1e-4
    assert row["compaction"]["reopen_replayed_records"] == 0
    assert row["evolution"]["queries_during_tune"] == 500
    assert row["chaos"]["ok"] and row["chaos"]["killed_writer_acks"] > 0
    assert not list(tmp_path.iterdir())  # the store is gone


# ------------------------------------------------- k' past 64 and M past 190


@pytest.mark.cuda
@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("k", [65, 80, 128, 400])
@pytest.mark.parametrize("W,TQ,TV", [(16, 64, 512), (64, 1, 420)])
def test_fused_knn_floor_passes(dev, grid, k, W, TQ, TV):
    """k past MAX_K: ceil(k / 64) launches, each admitting what ranks after
    the pass before; the lists laid end to end equal the plain version's
    top-k (1e-4, ids equal where untied), ragged n_live and units short of
    k valid rows included (TQ 1 is the re-rank's unit-warps kernel)."""
    q, v, valid = _case(dev, k + TQ, W, TQ, TV, 64, density=0.5)
    valid[:2, 40:] = False  # two units come up short in the first pass
    n_live = torch.randint(0, TQ + 1, (W,), device=dev, dtype=torch.int32)
    fn = GRIDS[grid]
    n0 = fn.launches
    got = fn(q, v, valid, k=k, n_live=n_live)
    torch.cuda.synchronize()
    assert fn.launches == n0 + -(-k // MAX_K)
    _check(got, fused_knn_plain(q, v, valid, k=k, n_live=n_live), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ADC)
@pytest.mark.parametrize("k", [65, 80, 128, 400])
def test_adc_floor_passes(dev, name, k):
    """The three ADC wrappers at k′ past 64: one launch a pass of 64, bit-equal
    to the plain version, padding slots and short units included."""
    W, TQ, TV = (1, 1, 5000) if name == "pq_scan" else (32, 64, 600)
    table, lut_idx, codes, valid = _adc_case(dev, k, W, TQ, TV, 8, density=0.5)
    valid[:2, 100:] = False
    fn = getattr(adc, name)
    n0 = fn.launches
    (gs, gi), (ws, wi) = _adc_run(name, table, lut_idx, codes, valid, k)
    torch.cuda.synchronize()
    assert fn.launches == n0 + -(-k // MAX_K)
    assert torch.equal(gs, ws) and torch.equal(gi, wi)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ADC)
@pytest.mark.parametrize("M", [191, 192, 256, 768, 769])
@pytest.mark.parametrize("k", [40, 80, 400])
def test_adc_wide_m(dev, name, M, k):
    """M past MAX_M: all three wrappers take adc_wide_m_kernel (a LUT row's
    slices staged once for a tile of rows), bit-equal to the plain version,
    odd M included; k′ 80 and 400 in passes of 64."""
    W, TQ, TV = (1, 1, 3000) if name == "pq_scan" else (8, 16, 600)
    table, lut_idx, codes, valid = _adc_case(dev, M + k, W, TQ, TV, M, U=40)
    n0, f0 = adc.adc_wide_m.launches, getattr(adc, name).launches
    (gs, gi), (ws, wi) = _adc_run(name, table, lut_idx, codes, valid, k)
    torch.cuda.synchronize()
    assert adc.adc_wide_m.launches == n0 + -(-k // MAX_K)
    assert getattr(adc, name).launches == f0
    assert torch.equal(gs, ws) and torch.equal(gi, wi)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ADC[:2])
@pytest.mark.parametrize("TV", [2300, 5000])
def test_adc_wide_m_long_units(dev, name, TV):
    """Units longer than a block's tile of 2,048 rows: the row tiles run one
    after another under the same lists, bit-equal to the plain version;
    slots sharing a table row (U 3) share its slices."""
    table, lut_idx, codes, valid = _adc_case(dev, TV, 3, 6, TV, 200, U=3, density=0.6)
    (gs, gi), (ws, wi) = _adc_run(name, table, lut_idx, codes, valid, 70)
    assert torch.equal(gs, ws) and torch.equal(gi, wi)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", sorted(GRIDS) + ["unit_warps"])
@pytest.mark.parametrize("D", [64, 256])
@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_f32_scans_bit_equal_to_plain(dev, grid, D, metric, dtype):
    """The f32 scans sum one fmaf chain per (query, row) over c = 0 … D-1,
    and the plain version (``ref.kernel_order_scores``) the same chain: the
    two are bit-equal, scores and ids, ties included (duplicated rows);
    through the split grid's merge, ``n_live``, a second pass (k 80) and the
    units of one query (``fused_knn_unit_warps_kernel``)."""
    W, TQ = (256, 1) if grid == "unit_warps" else (24, 64)
    q, v, valid = _case(dev, D + TQ, W, TQ, 700, D, density=0.6, dtype=dtype)
    v[:, 300:340] = v[:, :40]
    n_live = torch.randint(0, TQ + 1, (W,), device=dev, dtype=torch.int32)
    fn = fused_knn_db_stationary if grid == "unit_warps" else GRIDS[grid]
    for k in (10, 80):
        got = fn(q, v, valid, k=k, metric=metric, n_live=n_live)
        want = fused_knn_plain(q, v, valid, k=k, metric=metric, n_live=n_live)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_wide_launch_shapes_match_the_c_entries(dev):
    """The Python copies of the wide kernels' launch shapes
    (``flash_attention.wide_launch_shape``, ``pq_scan.wide_m_launch_shape``,
    which the CPU tests check) equal what the C entries compute."""
    import ctypes

    from repro_torch.kernels import _build

    lib = _build.library("flash_attention")
    out = (ctypes.c_int * 7)()
    for dh in (257, 264, 288, 384, 385, 512, 520, 640, 1025, 2048, 2100, 16384):
        for bf16 in (0, 1):
            assert lib.flash_attention_wide_shape(2, 100, 32, dh, bf16, ctypes.cast(out, ctypes.c_void_p)) == 0
            assert tuple(out) == fa.wide_launch_shape(2, 100, 32, dh, 2 if bf16 else 4), (dh, bf16)
    lib = _build.library("pq_scan")
    out6 = (ctypes.c_int * 6)()
    for w, tq, tv in ((1, 1, 20_000), (3, 5, 700), (4096, 64, 64), (256, 64, 256), (6, 8, 3000)):
        for dense in (0, 1):
            assert lib.adc_wide_m_shape(w, tq, tv, dense, 132, ctypes.cast(out6, ctypes.c_void_p)) == 0
            assert tuple(out6) == adc.wide_m_launch_shape(w, tq, tv, bool(dense), sms=132)
