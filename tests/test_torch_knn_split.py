"""The f32 scan's live-slot operand and the decomposition of its CUDA kernel,
on the CPU.

``n_live`` (real query slots per unit) is held against the reference's
Pallas grids in interpret mode on the live slots, with ``(NEG_INF, -1)`` on
the rest. ``_scan_emulation`` is the CUDA scan's decomposition in plain
Python (the split count, passes of compacted valid rows, 64-row tiles, a
query's rows dealt over L lanes, lane lists folded by halves, per-range
partial lists folded by the last block; a warp per unit when TQ = 1) over
the plain version's scores; it must equal the plain version bit for bit,
ties included. The kernels themselves are held against the plain version
on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as ref_ops
from repro_torch.core.plan import build_plan
from repro_torch.core.planner import _assemble_bucket, live_slots
from repro_torch.kernels import ops, ref
from repro_torch.kernels.fused_knn import (
    fused_knn,
    fused_knn_db_stationary,
    fused_knn_plain,
    scan_smem_bytes,
    split_count,
)

GRIDS = {"fused_knn": fused_knn, "fused_knn_db_stationary": fused_knn_db_stationary}
N_LIVE = {"zero": lambda tq: [0, 0, 0, 0], "one": lambda tq: [1, 1, 1, 1],
          "full": lambda tq: [tq] * 4, "ragged": lambda tq: [0, 1, tq, 5]}


def _case(seed, w, tq, tv, d, density=0.6, dup=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(w, tq, d)).astype(np.float32)
    v = rng.normal(size=(w, tv, d)).astype(np.float32)
    if dup:  # every unit's rows repeat in blocks of three: exact ties
        v = np.repeat(v[:, ::3], 3, axis=1)[:, :tv].copy()
    valid = rng.random((w, tv)) < density
    return q, v, valid


@pytest.mark.parametrize("pattern", sorted(N_LIVE))
@pytest.mark.parametrize("tv", [48, 256])
def test_n_live_matches_pallas_interpret(pattern, tv):
    """``ops.workunit_topk`` with ``n_live`` (TV 48: the query-stationary
    grid; 256: the split grid) and the plain version called directly: the
    live slots equal the reference's Pallas dispatch in interpret mode
    (scores within 1e-4, ids equal), every other slot is (NEG_INF, -1)."""
    tq = 8
    q, v, valid = _case(tv + len(pattern), 4, tq, tv, 16)
    n_live = np.array(N_LIVE[pattern](tq), dtype=np.int32)
    rs, ri = ref_ops.workunit_topk(jnp.asarray(q), jnp.asarray(v), jnp.asarray(valid), 6,
                                   metric="l2", use_pallas=True, interpret=True)
    rs, ri = np.asarray(rs), np.asarray(ri)
    args = (torch.from_numpy(q), torch.from_numpy(v), torch.from_numpy(valid))
    nl = torch.from_numpy(n_live)
    got = {"ops": ops.workunit_topk(*args, 6, metric="l2", n_live=nl),
           "plain": fused_knn_plain(*args, k=6, metric="l2", n_live=nl)}
    live = np.arange(tq)[None, :] < n_live[:, None]
    for s, i in got.values():
        s, i = s.numpy(), i.numpy()
        np.testing.assert_allclose(s[live], rs[live], rtol=1e-4, atol=1e-4)
        assert np.array_equal(i[live], ri[live])
        assert (i[~live] == -1).all() and (s[~live] == np.float32(ref.NEG_INF)).all()


def test_n_live_none_is_every_slot():
    q, v, valid = (torch.from_numpy(x) for x in _case(3, 2, 5, 40, 8))
    full = torch.full((2,), 5, dtype=torch.int32)
    for fn in GRIDS.values():
        a = fn(q, v, valid, k=4)
        b = fn(q, v, valid, k=4, n_live=full)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError, match="n_live"):
        fused_knn(q, v, valid, k=4, n_live=full.long())


# ------------------------------------------------------ the decomposition


class _List:
    """A warp's list for one slot: offered 32 candidates at a time, those
    that rank above its k-th entry (all, while it holds fewer) are ranked
    with it by count under (score desc, index asc); it keeps the first k."""

    def __init__(self, k):
        self.k, self.keys = k, []

    def offer(self, chunk):
        full = len(self.keys) == self.k
        passing = [(-s, i) for s, i in chunk if not full or (-s, i) < self.keys[-1]]
        self.keys = sorted(self.keys + passing)[:self.k]

    def entries(self):
        return [(-s, i) for s, i in self.keys]


def _final(lst, k):
    """The public encoding: the first k entries; (NEG_INF, -1) where none."""
    e = lst.entries()
    s = [x[0] for x in e] + [ref.NEG_INF] * (k - len(e))
    i = [(-1 if x[0] <= ref.NEG_INF / 2 else x[1]) for x in e] + [-1] * (k - len(e))
    return s, i


def _scan_emulation(q, v, valid, *, k, metric, n_live=None, S=None, seed=0):
    """The CUDA scan's decomposition over the kernels' fp32 scores
    (``ref.kernel_order_scores``, the plain version's): a
    block per (unit, chunk of 64 slots, row range) (a warp per unit when
    TQ = 1); passes of 256 rows whose valid rows are compacted; tiles of 32
    of them, whose scores that rank above a slot's k-th entry are ranked
    with its list; at S > 1 each range's first k entries stored and the
    S·k of a slot taken 32 at a time by the last block (here in a shuffled
    order of ranges). ``S``: ranges per (unit, chunk), default
    ``split_count``."""
    W, TQ, _ = q.shape
    TV = v.shape[1]
    sc = ref.kernel_order_scores(q, v, metric).tolist()
    ok = valid.tolist()
    live = [TQ] * W if n_live is None else [min(max(int(x), 0), TQ) for x in n_live]
    out_s = np.full((W, TQ, k), ref.NEG_INF, np.float32)
    out_i = np.full((W, TQ, k), -1, np.int32)
    rng = random.Random(seed)
    S = split_count(W, TQ, TV) if S is None else S
    chunk_rows = -(-(-(-TV // 32)) // S) * 32
    S = -(-TV // chunk_rows)
    for w in range(W):
        for q0 in range(0, TQ, 64):
            n = min(max(live[w] - q0, 0), min(64, TQ - q0))
            partial = []  # each range's first k entries per live slot
            for split in range(S):
                lists = [_List(k) for _ in range(n)]
                row0, row1 = split * chunk_rows, min(TV, (split + 1) * chunk_rows)
                for p0 in range(row0, row1, 256):
                    rows = [r for r in range(p0, min(row1, p0 + 256)) if ok[w][r]]
                    for t0 in range(0, len(rows), 32):
                        for s in range(n):
                            lists[s].offer([(sc[w][q0 + s][r], r) for r in rows[t0:t0 + 32]])
                partial.append([lst.entries()[:k] for lst in lists])
            for s in range(n):
                lst = _List(k)
                if S == 1:
                    lst.offer(partial[0][s])
                else:
                    order = list(range(S))
                    rng.shuffle(order)
                    flat = [e for sp in order for e in partial[sp][s]]
                    for f0 in range(0, len(flat), 32):
                        lst.offer(flat[f0:f0 + 32])
                out_s[w, q0 + s], out_i[w, q0 + s] = _final(lst, k)
    return torch.from_numpy(out_s), torch.from_numpy(out_i)


EMULATED = {  # (W, TQ, TV, D, k, density, dup)
    "random": (3, 9, 300, 8, 10, 0.6, False),
    "ties": (2, 20, 200, 6, 16, 0.8, True),
    "two_query_chunks": (2, 70, 130, 4, 5, 0.5, False),
    "long_units": (1, 3, 2500, 4, 40, 0.5, True),
    "sparse": (3, 6, 400, 5, 12, 0.01, False),
    "one_query": (5, 1, 300, 8, 10, 0.5, True),
}


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("case", sorted(EMULATED))
def test_kernel_decomposition_is_bit_exact(case, metric):
    """``_scan_emulation`` equals the plain version bit for bit, ties and
    dead slots included, at the kernel's S, at S = 1 and at S = 2, 3 and the
    most ranges (one 32-row tile each)."""
    W, TQ, TV, D, k, density, dup = EMULATED[case]
    q, v, valid = (torch.from_numpy(x) for x in _case(len(case), W, TQ, TV, D, density, dup))
    n_live = torch.tensor([(TQ * (j + 1)) // W - (j % 2) for j in range(W)], dtype=torch.int32)
    want = fused_knn_plain(q, v, valid, k=k, metric=metric, n_live=n_live)
    if dup:
        assert (want[0][..., 1:] == want[0][..., :-1]).any()
    for S in sorted({None, 1, 2, 3, -(-TV // 32)}, key=lambda s: -1 if s is None else s):
        got = _scan_emulation(q, v, valid, k=k, metric=metric, n_live=n_live, S=S)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), S
    got = _scan_emulation(q, v, valid, k=k, metric=metric)
    want = fused_knn_plain(q, v, valid, k=k, metric=metric)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_split_count():
    """Ranges are whole 32-row tiles, at least 8 each; the grid fills at
    least two waves of 132 blocks unless the ranges are within twice that
    least size (it aims for 4 · 132, and rounding ranges to whole tiles
    costs at most half of that); units of one query never split. The main path's split buckets:
    S 1, 1, 3, 8, 16 at TV 256 … 4096."""
    assert [split_count(w, 64, tv) for w, tv in
            ((4096, 256), (2048, 512), (256, 1024), (64, 2048), (8, 4096))] == [1, 1, 3, 8, 16]
    assert split_count(16384, 1, 40) == 1 and split_count(2, 1, 4096) == 1
    for w, tq, tv in ((1, 64, 64), (2, 64, 4096), (3, 130, 1100), (64, 64, 4096), (7, 5, 37)):
        s = split_count(w, tq, tv)
        tiles = -(-tv // 32)
        chunk = -(-tiles // s) * 32  # the kernel's rows a range
        assert 1 <= s and (s - 1) * chunk < tv <= s * chunk
        assert s == 1 or chunk >= 8 * 32
        assert w * -(-tq // 64) * s >= 2 * 132 or s == 1 or chunk < 2 * 8 * 32


@pytest.mark.parametrize("d", [64, 65, 453, 454, 768, 1024, 4096])
def test_any_width_fits(d):
    """Rows are staged 64 elements at a time, so no width is refused, and
    past one chunk a block's shared memory does not grow with d (under the
    227 KB a block may take at every k)."""
    for k in (1, 10, 33, 64):
        assert scan_smem_bytes(d, k) == scan_smem_bytes(64 if d <= 64 else 128, k) <= 227 * 1024


def test_engine_units_hold_their_queries_first():
    """The engine's units hold their real slots first (``_assemble_bucket``),
    so one count per unit (``live_slots``) names them."""
    from repro_torch.core.workload import kg_style
    from repro_torch.core.hqi import HQIIndex, HQIConfig
    from repro_torch.core.ivf import ScanStats

    kg = kg_style(n=6000, d=8, queries_per_split=60, seed=2)
    wl = kg.splits[1]
    index = HQIIndex.build(kg.db, kg.splits[0], HQIConfig(min_partition_size=128, max_leaves=16),
                           device="cpu")
    tasks, _, _ = index._engine_tasks(wl, nprobe=4, batch_vec=True, stats=ScanStats())
    plan = build_plan(index.arena, tasks, wl.vectors, m=wl.m, k=wl.k, cfg=index.cfg.plan)
    assert plan.buckets
    for lp in plan.buckets:
        _, _, qrow_of, _ = _assemble_bucket(plan.buckets[lp], lp, plan, index.arena)
        n = live_slots(qrow_of, "cpu").numpy()
        slot = np.arange(qrow_of.shape[1])[None, :]
        assert np.array_equal(qrow_of >= 0, slot < n[:, None])
