"""Stage 2 of the execution engine: megabatched execution of a global plan.

``plan.py`` (stage 1) turns a whole workload into one ``ExecutionPlan`` whose
work units are bucketed by padded shape across every partition and template.
This module executes that plan on the arena's device:

  1. for each shape bucket, gather ALL its units' posting-list rows from the
     index-wide ``PackedArena`` (one device ``index_select`` serves every
     partition) and run them in a single ``kernels.ops.workunit_topk``
     dispatch — the fused masked scan + top-k of Alg. 3 line 10, megabatched
     across the workload;
  2. scatter per-unit top-k into the candidate buffer on the device — by
     default a flat segmented (CSR-style) [Σ seg_counts, k] buffer whose
     per-query segment widths come from ``ExecutionPlan.seg_counts``
     (``merge_layout="segmented"``); ``merge_layout="dense"`` keeps the
     [m, n_slots, k] tensor padded to the widest query — then fold in any
     per-query scan results the adaptive executor produced host-side;
  3. reduce candidates to the final per-query top-k with ONE device-side
     reduction (``ops.segmented_merge_topk`` / ``ops.merge_topk``). Both
     layouts are bit-identical: the segmented merge's stable sort keeps the
     dense layout's slot-major tie order.

Compressed execution (``PlanConfig.scan_mode="pq"``): the scan stage reads
the arena's uint8 PQ codes instead of f32 vectors. The workload's ADC tables
go to the device once as a resident [U, M, 256] table; each bucket is one ADC
dispatch keeping k′ = refine_factor · k candidates per (query, posting list):
``ops.workunit_pq_topk_resident`` on the segmented layout (the kernel reads
each slot's LUT row from the table, so nothing is expanded),
``ops.workunit_pq_topk`` over per-bucket expanded [W, TQ, M, 256] LUTs on the
dense one (``DispatchStats.lut_expand_bytes`` meters them). One merge keeps
each query's top-k′ rows, their f32 rows are gathered from the arena once,
and one ``workunit_topk`` dispatch re-ranks them exactly; the final merge
folds in the adaptive executor's (exact) host-side candidates as on the f32
path.

Sharded execution (``execute_plan_sharded``): the same two stages across a
device mesh (``launch/mesh.py``), single-controller as the reference's
``shard_map`` is. Per shared shape bucket every rank assembles its own units'
operands on its device from its arena shard (``bucket_operands`` /
``pq_bucket_operands`` with ``shard=``), and one ``ops.sharded_*`` dispatch
launches the kernel once per device over the ranks' units concatenated.
Candidates reduce in two hops: a rank-local top-k (one segmented merge per
device over its ranks' segments, or each rank's dense tensor), then the
gather merge (``ops.sharded_merge_topk``, k·|model| candidates per query).
Every (query, posting-list) pair is scored on exactly one rank by the same
per-unit kernel, and an f32 score is one ``fmaf`` chain over D whatever the
stacking, so results are bit-identical to ``execute_plan`` (ties at the k or
k′ boundary aside, as in the reference); ``core/distributed.py`` is the thin
mesh entry.

``batch_search_ivf`` is the single-index entry point (the baselines use it):
a one-partition arena, a one-task plan, executed here. Every dispatch and merge
sits in a tracer span and, while a profiler is enabled (``obs.profile``),
records the reference's shape facts (bytes, FLOPs, units, rows, each real
and padded), computed from the padded bucket shapes by the reference's
formulas, so both packages record equal rows for the same plan.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops as kops
from ..kernels.pq_scan import NBOOK
from ..obs.profile import get_profiler
from ..obs.trace import fence, get_tracer
from .arena import ArenaShard, PackedArena, ShardedArena
from .ivf import IVFIndex, ScanStats
from .plan import (
    EngineTask,
    ExecutionPlan,
    PlanConfig,
    ShardedPlan,
    WorkUnit,
    _next_pow2,
    build_plan,
)
from .pq import PQCodebook, adc_tables

# Extra per-query candidates merged alongside the plan's output (the adaptive
# executor's host-side scans): (qrows i64 [mq], scores f32 [mq, k], ids i64 [mq, k])
ExtraCandidates = Tuple[np.ndarray, np.ndarray, np.ndarray]


def _nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _account_candidates(stats: Optional[ScanStats], nbytes: int) -> None:
    """Record one candidate merge buffer allocation (scores + ids bytes):
    per-search peak in ScanStats, process-wide peak in DispatchStats."""
    kops.dispatch_stats().record_candidate_bytes(nbytes)
    if stats is not None:
        stats.peak_candidate_bytes = max(stats.peak_candidate_bytes, int(nbytes))


def _account_lut(stats: Optional[ScanStats], nbytes: int, *, expanded: bool) -> None:
    """Record ADC LUT bytes materialized on the device. ``expanded=True``
    marks a per-unit [W, TQ, M, 256] expansion (the dense layout's operand)
    and also feeds ``DispatchStats.lut_expand_bytes``, which the segmented
    path leaves untouched."""
    if expanded:
        kops.dispatch_stats().record_lut_expand(nbytes)
    if stats is not None:
        stats.lut_bytes += int(nbytes)


def _seg_offsets(
    plan_counts: np.ndarray, extra: Sequence[ExtraCandidates], m: int
) -> Tuple[np.ndarray, np.ndarray]:
    """CSR layout of the flat candidate buffer: (counts [m], offsets [m+1]).

    Query q owns flat rows offsets[q] .. offsets[q+1]-1 — its plan slots
    first (``plan_counts[q]`` of them, addressed as offsets[q] + slot), then
    one row per host-side extra. The per-query order matches the dense
    tensor's slot-major flattening, so the segmented merge selects the
    identical top-k (ties included)."""
    extra_counts = np.zeros(m, dtype=np.int64)
    for qrows, _, _ in extra:
        extra_counts[qrows] += 1
    counts = plan_counts + extra_counts
    offsets = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return counts, offsets


def _assemble_bucket(
    units: List[WorkUnit],
    lp: int,
    plan: ExecutionPlan,
    arena: PackedArena,
    w_pad: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Scan-stage assembly for one shape bucket (host numpy).

    Returns (Vrows i64 [W, lp] packed rows to gather, valid bool [W, lp],
    qrow_of i64 [W, tq] workload query row per unit slot (-1 pad),
    slot_of i64 [W, tq] merge-tensor slot per unit slot). W is the unit count
    padded to a power of two, as in the reference, so the dispatch shapes
    (``DispatchStats.shapes``) agree, or ``w_pad`` (the sharded path's width
    shared by every rank); padding units are fully masked.
    """
    tq = plan.tq
    n_packed = arena.n
    W = _next_pow2(len(units), 1) if w_pad is None else int(w_pad)
    Vrows = np.zeros((W, lp), dtype=np.int64)
    valid = np.zeros((W, lp), dtype=bool)
    qrow_of = np.full((W, tq), -1, dtype=np.int64)
    slot_of = np.zeros((W, tq), dtype=np.int64)
    ar = np.arange(lp)
    for w, u in enumerate(units):
        s0 = int(arena.list_start[u.glist])
        llen = int(arena.list_len[u.glist])
        rows = np.minimum(ar + s0, n_packed - 1)
        Vrows[w] = rows
        v_ok = ar < llen
        task = plan.tasks[u.task]
        if task.packed_bitmap is not None:
            pb = task.packed_bitmap
            local = np.minimum(rows - int(arena.part_row[task.part]), len(pb) - 1)
            v_ok = v_ok & pb[local]
        valid[w] = v_ok
        nq = len(u.qrows)
        qrow_of[w, :nq] = u.qrows
        slot_of[w, :nq] = u.slots
    return Vrows, valid, qrow_of, slot_of


def execute_plan(
    plan: ExecutionPlan,
    arena: Optional[PackedArena],  # None allowed iff the plan has no buckets
    q_vecs: np.ndarray,  # f32 [m, d]
    *,
    cfg: Optional[PlanConfig] = None,
    extra: Sequence[ExtraCandidates] = (),
    stats: Optional[ScanStats] = None,
    device=None,  # where the merge runs when there is no arena; default: the arena's
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (scores f32 [m, k] best-first, arena gids i64 [m, k]; -1 pad)."""
    cfg = PlanConfig() if cfg is None else cfg
    if cfg.scan_mode not in ("f32", "pq"):
        raise ValueError(f"unknown scan_mode {cfg.scan_mode!r}")
    if cfg.merge_layout not in ("segmented", "dense"):
        raise ValueError(f"unknown merge_layout {cfg.merge_layout!r}")
    if cfg.scan_mode == "pq" and plan.buckets:
        if arena.codes is None or arena.pq is None:
            raise ValueError(
                "scan_mode='pq' needs a PQ-encoded arena: build the HQIIndex "
                "with HQIConfig(scan_mode='pq') or attach_pq() a codebook, or "
                "pass pq= to batch_search_ivf"
            )
        return _execute_plan_pq(plan, arena, q_vecs, cfg=cfg, extra=extra, stats=stats)
    m, k = plan.m, plan.k
    # extras get per-query-dense slot columns after the plan's own slots
    n_slots = plan.n_slots + _extra_slot_width(extra, m)
    if m == 0 or n_slots == 0:
        return (
            np.full((m, k), -np.inf, np.float32),
            np.full((m, k), -1, np.int64),
        )
    dev = arena.device if arena is not None else torch.device(device or "cuda")
    if cfg.merge_layout == "segmented":
        return _execute_plan_f32_segmented(
            plan, arena, q_vecs, extra=extra, stats=stats, dev=dev
        )

    out_scores = torch.full((m, n_slots, k), -float("inf"), dtype=torch.float32, device=dev)
    out_idx = torch.full((m, n_slots, k), -1, dtype=torch.int64, device=dev)
    _account_candidates(stats, _nbytes(out_scores, out_idx))
    for kk, qr, sl, s_w, gidx_w in _iter_f32_buckets(plan, arena, q_vecs, stats):
        qr_t, sl_t = torch.from_numpy(qr).to(dev), torch.from_numpy(sl).to(dev)
        out_scores[qr_t, sl_t, :kk] = s_w
        out_idx[qr_t, sl_t, :kk] = gidx_w
    return _fold_extras_and_merge(out_scores, out_idx, extra, plan.n_slots, k)


def _bucket_rows(plan, arena, lp, units, w_pad, shard):
    """``_assemble_bucket`` of a bucket's units (all of them, or a rank's),
    with the rows to gather on the device that holds them: the arena's, or
    with ``shard`` that rank's own rows (``ArenaShard.local``) on its device.
    Returns (Vrows, valid, qrow_of, slot_of, source, rows tensor)."""
    units = plan.buckets[lp] if units is None else units
    Vrows, valid, qrow_of, slot_of = _assemble_bucket(units, lp, plan, arena, w_pad=w_pad)
    src = arena if shard is None else shard
    if shard is not None:
        Vrows = shard.local(Vrows)
    return Vrows, valid, qrow_of, slot_of, src, torch.from_numpy(Vrows).to(src.device)


def bucket_operands(
    plan: ExecutionPlan,
    arena: PackedArena,
    q_dev: torch.Tensor,
    lp: int,
    *,
    units: Optional[List[WorkUnit]] = None,
    w_pad: Optional[int] = None,
    shard: Optional[ArenaShard] = None,
):
    """One bucket's scan operands on the arena's device.

    Returns (qrow_of i64 [W, tq] host, slot_of i64 [W, tq] host, rows
    [W, lp] packed rows, Q [W, tq, d] with padding slots zeroed, V [W, lp, d]
    gathered by one ``index_select``, valid bool [W, lp]). On the sharded
    path, rank r's: its ``units`` of the bucket, W = ``w_pad``, ``rows`` its
    shard's own, on its device (``q_dev`` there too).
    """
    _, valid, qrow_of, slot_of, src, rows = _bucket_rows(plan, arena, lp, units, w_pad, shard)
    dev = src.device
    qrow_t = torch.from_numpy(qrow_of).to(dev)
    Q = q_dev[qrow_t.clamp(min=0)]
    Q = torch.where((qrow_t >= 0)[..., None], Q, torch.zeros((), device=dev))
    V = src.packed.index_select(0, rows.reshape(-1)).reshape(rows.shape[0], lp, arena.d)
    return qrow_of, slot_of, rows, Q, V, torch.from_numpy(valid).to(dev)


def live_slots(qrow_of: np.ndarray, dev) -> torch.Tensor:
    """Real query slots per unit (i32 [W]) of a bucket whose units hold
    their queries in slots 0 … n-1 (``_assemble_bucket``), -1 after."""
    return torch.from_numpy((qrow_of >= 0).sum(axis=1).astype(np.int32)).to(dev)


def _iter_f32_buckets(plan, arena, q_vecs, stats):
    """Run the f32 scan stage bucket by bucket (one ``workunit_topk`` dispatch
    each), yielding (kk, qrows, slots, scores [n, kk], gids [n, kk]) for the
    real unit slots: host index arrays, device result tensors. The scatter
    destination is the only thing the dense and segmented layouts disagree
    on, so the scan lives here once."""
    if not plan.buckets:
        return
    dev = arena.device
    prof = get_profiler()
    d, tq = arena.d, plan.tq
    q_dev = torch.from_numpy(np.ascontiguousarray(q_vecs, dtype=np.float32)).to(dev)
    for lp in sorted(plan.buckets):
        n_units = len(plan.buckets[lp])
        qrow_of, slot_of, rows, Q, V, valid = bucket_operands(plan, arena, q_dev, lp)
        if stats is not None:
            # real work units only (pow2 pad excluded)
            stats.bytes_scanned += n_units * lp * arena.d * 4
        n_live = live_slots(qrow_of, dev)
        kk = min(plan.k, lp)
        t0 = prof.t0() if prof.enabled else 0
        with get_tracer().span("dispatch.scan", mode="f32", lp=lp, units=n_units):
            s, i_loc = kops.workunit_topk(Q, V, valid, kk, metric=arena.metric, n_live=n_live)
            s, i_loc = fence(s, i_loc)  # device time is real iff tracing or profiling is on
        wmask = qrow_of >= 0  # [W, tq]
        if prof.enabled:
            # real distance work: 2·d MACs per (query, live row) pair within
            # each unit; padded work covers the full [W, tq, lp] bucket
            W = Q.shape[0]
            nq_u = wmask.sum(axis=1)
            rows_u = valid.sum(dim=1).cpu().numpy()
            prof.record_dispatch(
                "scan", "f32", lp, t0,
                nbytes=W * tq * d * 4 + W * lp * d * 4 + W * lp + W * tq * kk * 12,
                flops=2.0 * d * float((nq_u * rows_u).sum()),
                flops_padded=2.0 * d * W * tq * lp,
                units=n_units, units_padded=W,
                rows=int(rows_u.sum()), rows_padded=W * lp,
            )
        packed_rows = _unit_rows(rows, i_loc)
        gidx = torch.where(packed_rows < 0, -1, arena.gid[packed_rows.clamp(min=0)])
        wmask_t = torch.from_numpy(wmask).to(dev)
        yield s.shape[-1], qrow_of[wmask], slot_of[wmask], s[wmask_t], gidx[wmask_t]


def _unit_rows(rows: torch.Tensor, i_loc: torch.Tensor) -> torch.Tensor:
    """Packed rows of a bucket's per-unit top-k: rows i64 [W, lp], i_loc
    [W, tq, kk] indices into each unit's lp rows (-1 = none) -> i64
    [W, tq, kk], -1 where none."""
    i_loc = i_loc.to(torch.int64)
    packed_rows = torch.gather(rows[:, None, :].expand(-1, i_loc.shape[1], -1), 2, i_loc.clamp(min=0))
    return torch.where(i_loc < 0, -1, packed_rows)


def _plan_seg_counts(plan: ExecutionPlan) -> np.ndarray:
    """Per-query plan slot counts, tolerating plans built without the field
    (hand-constructed): fall back to the dense assumption that every query
    owns ``n_slots`` slots."""
    if len(plan.seg_counts) == plan.m:
        return plan.seg_counts
    return np.full(plan.m, plan.n_slots, dtype=np.int64)


def _execute_plan_f32_segmented(
    plan: ExecutionPlan,
    arena: Optional[PackedArena],
    q_vecs: np.ndarray,
    *,
    extra: Sequence[ExtraCandidates],
    stats: Optional[ScanStats],
    dev: torch.device,
) -> Tuple[np.ndarray, np.ndarray]:
    """Segmented (CSR) counterpart of the dense f32 path.

    Per-unit top-ks scatter into ONE flat [C_pad, k] device buffer at
    offsets[q] + slot — query q's segment holds exactly its own plan slots
    plus its host-side extras, so peak merge memory is Σ seg_counts·k
    instead of m·n_slots·k. One ``segmented_merge_topk`` dispatch reduces
    every ragged segment; within each segment candidates keep the dense
    layout's slot-major order, so results are bit-identical.
    """
    m, k = plan.m, plan.k
    plan_counts = _plan_seg_counts(plan)
    counts, offsets = _seg_offsets(plan_counts, extra, m)
    C_total = int(offsets[-1])
    C_pad = _next_pow2(C_total, 1)
    flat_s = torch.full((C_pad, k), -float("inf"), dtype=torch.float32, device=dev)
    flat_i = torch.full((C_pad, k), -1, dtype=torch.int64, device=dev)
    seg_of = np.full(C_pad, m, dtype=np.int32)  # pad rows -> dropped segment
    seg_of[:C_total] = np.repeat(np.arange(m, dtype=np.int32), counts)
    _account_candidates(stats, _nbytes(flat_s, flat_i))

    for kk, qr, sl, s_w, gidx_w in _iter_f32_buckets(plan, arena, q_vecs, stats):
        rows = torch.from_numpy(offsets[qr] + sl).to(dev)
        flat_s[rows, :kk] = s_w
        flat_i[rows, :kk] = gidx_w

    # extras take the rows after each query's plan slots (same relative order
    # as the dense layout's extra columns)
    next_extra = plan_counts.copy()
    for qrows, es, ei in extra:
        kk = min(k, es.shape[1])
        rows = torch.from_numpy(offsets[qrows] + next_extra[qrows]).to(dev)
        next_extra[qrows] += 1
        flat_s[rows, :kk] = torch.from_numpy(np.ascontiguousarray(es[:, :kk])).to(dev)
        flat_i[rows, :kk] = torch.from_numpy(np.ascontiguousarray(ei[:, :kk])).to(dev)

    prof = get_profiler()
    t0 = prof.t0() if prof.enabled else 0
    with get_tracer().span("merge.segmented", m=m, candidates=C_total):
        top_s, top_i = kops.segmented_merge_topk(
            flat_s, flat_i, torch.from_numpy(seg_of).to(dev), m, k
        )
        top_s, top_i = fence(top_s, top_i)
    if prof.enabled:
        prof.record_dispatch(
            "merge", "segmented", C_pad, t0,
            nbytes=_nbytes(flat_s, flat_i) + seg_of.nbytes + m * k * 12,
            flops=0.0, flops_padded=0.0,
            units=m, units_padded=m,
            rows=C_total, rows_padded=C_pad,
        )
    return top_s.cpu().numpy(), top_i.cpu().numpy()


def _extra_slot_width(extra: Sequence[ExtraCandidates], m: int) -> int:
    """Max per-query count of host-side extra candidate columns."""
    extra_slots = np.zeros(m, dtype=np.int64)
    for qrows, _, _ in extra:
        extra_slots[qrows] += 1
    return int(extra_slots.max()) if m else 0


def _fold_extras_and_merge(
    out_scores: torch.Tensor,  # f32 [m, n_slots, k] — base candidates filled in
    out_idx: torch.Tensor,  # i64 [m, n_slots, k]
    extra: Sequence[ExtraCandidates],
    base_slots: int,  # extras occupy slot columns base_slots, base_slots+1, ...
    k: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Fold the adaptive executor's host-side candidates in, then final-merge."""
    m = out_scores.shape[0]
    dev = out_scores.device
    next_extra = np.full(m, base_slots, dtype=np.int64)
    for qrows, es, ei in extra:
        kk = min(k, es.shape[1])
        slot = next_extra[qrows]
        next_extra[qrows] += 1
        qr_t, sl_t = torch.from_numpy(qrows).to(dev), torch.from_numpy(slot).to(dev)
        out_scores[qr_t, sl_t, :kk] = torch.from_numpy(np.ascontiguousarray(es[:, :kk])).to(dev)
        out_idx[qr_t, sl_t, :kk] = torch.from_numpy(np.ascontiguousarray(ei[:, :kk])).to(dev)
    top_s, top_i = _padded_merge(out_scores.reshape(m, -1), out_idx.reshape(m, -1), k)
    return top_s.cpu().numpy(), top_i.cpu().numpy()


def _padded_merge(
    flat_s: torch.Tensor, flat_i: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """merge_topk with the candidate width padded to a power of two, as in
    the reference (padding columns are absent candidates)."""
    real_width = flat_s.shape[1]
    width = _next_pow2(real_width, k)
    if width > real_width:
        padc = width - real_width
        flat_s = torch.nn.functional.pad(flat_s, (0, padc), value=-float("inf"))
        flat_i = torch.nn.functional.pad(flat_i, (0, padc), value=-1)
    mq = flat_s.shape[0]
    prof = get_profiler()
    t0 = prof.t0() if prof.enabled else 0
    with get_tracer().span("merge.final", m=mq, width=width):
        s, i = kops.merge_topk(flat_s, flat_i, k)
        s, i = fence(s, i)
    if prof.enabled:
        prof.record_dispatch(
            "merge", "final", width, t0,
            nbytes=_nbytes(flat_s, flat_i) + mq * k * 12,
            flops=0.0, flops_padded=0.0,
            units=mq, units_padded=mq,
            rows=mq * real_width, rows_padded=mq * width,
        )
    return s, i


# ------------------------------------------------------------- compressed


def _execute_plan_pq(
    plan: ExecutionPlan,
    arena: PackedArena,
    q_vecs: np.ndarray,  # f32 [m, d]
    *,
    cfg: PlanConfig,
    extra: Sequence[ExtraCandidates] = (),
    stats: Optional[ScanStats] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Compressed two-stage execution: ADC scan over codes, then exact re-rank.

    Stage A: per shape bucket one ADC dispatch over the unit's uint8 code
    rows keeps k′ = refine_factor · k candidates per (query, posting list).
    Stage B: one merge per query to the top-k′ (over ADC scores), one gather
    of their f32 rows, one ``workunit_topk`` dispatch re-scoring them
    exactly, then the final merge with the host-side extras.
    """
    m, k = plan.m, plan.k
    dev = arena.device
    kprime = max(k, int(cfg.refine_factor) * k)

    luts_dev, lut_pos = resident_luts(plan, arena, q_vecs)
    _account_lut(stats, _nbytes(luts_dev), expanded=False)

    stage_a = _pq_stage_a_segmented if cfg.merge_layout == "segmented" else _pq_stage_a_dense
    rows = stage_a(plan, arena, luts_dev, lut_pos, kprime, stats=stats)
    return _pq_rerank_and_fold(arena, q_vecs, rows, k=k, kprime=kprime, extra=extra, stats=stats)


def resident_luts(plan: ExecutionPlan, arena: PackedArena, q_vecs: np.ndarray):
    """The workload's resident ADC table on the arena's device: (f32
    [U, M, 256] for the U queries the plan scans, i64 [m] table row of each
    workload query). Queries the adaptive executor sent to host-side
    extras get no row."""
    used = np.unique(np.concatenate([u.qrows for units in plan.buckets.values() for u in units]))
    lut_pos = np.zeros(plan.m, dtype=np.int64)
    lut_pos[used] = np.arange(len(used))
    return torch.from_numpy(adc_tables(arena.pq, q_vecs[used])).to(arena.device), lut_pos


def pq_bucket_operands(
    plan: ExecutionPlan,
    arena: PackedArena,
    lut_pos: np.ndarray,
    lp: int,
    *,
    units: Optional[List[WorkUnit]] = None,
    w_pad: Optional[int] = None,
    shard: Optional[ArenaShard] = None,
):
    """One bucket's ADC scan operands on the arena's device.

    Returns (qrow_of i64 [W, tq] host, slot_of i64 [W, tq] host, rows [W, lp]
    packed rows, lut_idx i32 [W, tq] row of the resident LUT table per slot
    (``lut_pos`` of its query; -1 for a padding slot, which the resident
    kernel never scores: ``repro`` points it at row 0, and both engines drop
    its output), codes uint8 [W, lp, M] gathered by one ``index_select``,
    valid bool [W, lp]). ``units``, ``w_pad`` and ``shard`` as in
    ``bucket_operands``.
    """
    _, valid, qrow_of, slot_of, src, rows = _bucket_rows(plan, arena, lp, units, w_pad, shard)
    dev = src.device
    lut_idx = torch.from_numpy(np.where(qrow_of >= 0, lut_pos[np.maximum(qrow_of, 0)], -1)
                               .astype(np.int32)).to(dev)
    codes = src.codes.index_select(0, rows.reshape(-1)).reshape(rows.shape[0], lp, arena.pq.m)
    return qrow_of, slot_of, rows, lut_idx, codes, torch.from_numpy(valid).to(dev)


def _iter_pq_buckets(plan, arena, luts_dev, lut_pos, kprime, *, resident: bool, stats):
    """Run the ADC scan stage bucket by bucket, yielding (kk, qrows, slots,
    scores [n, kk], packed rows [n, kk]) for the real unit slots. With
    ``resident`` each dispatch reads the [U, M, 256] table through per-slot
    row indices; otherwise the bucket's [W, tq, M, 256] LUTs are expanded
    first (the dense layout)."""
    dev = arena.device
    M = arena.pq.m
    prof = get_profiler()
    for lp in sorted(plan.buckets):
        n_units = len(plan.buckets[lp])
        qrow_of, slot_of, rows, lut_idx, codes, valid_t = pq_bucket_operands(plan, arena, lut_pos, lp)
        W = rows.shape[0]
        if stats is not None:
            stats.bytes_scanned += n_units * lp * M  # real work units only
        kk = min(kprime, lp)
        t0 = prof.t0() if prof.enabled else 0
        if resident:
            with get_tracer().span("dispatch.scan", mode="pq-res", lp=lp, units=n_units):
                s, i_loc = kops.workunit_pq_topk_resident(luts_dev, lut_idx, codes, valid_t, kk)
                s, i_loc = fence(s, i_loc)
        else:
            # padding slots expand row 0, as in ``repro``; the kernel reads only the
            # live ones (``n_live``) and both engines drop the others' outputs
            luts = luts_dev.index_select(0, lut_idx.clamp(min=0).reshape(-1)).reshape(W, plan.tq, M, NBOOK)
            _account_lut(stats, _nbytes(luts), expanded=True)
            with get_tracer().span("dispatch.scan", mode="pq", lp=lp, units=n_units):
                s, i_loc = kops.workunit_pq_topk(luts, codes, valid_t, kk,
                                                 n_live=live_slots(qrow_of, dev))
                s, i_loc = fence(s, i_loc)
            del luts
        wmask = qrow_of >= 0
        if prof.enabled:
            # the reference's counts: 2·M·256 MACs per (query, live row) (its
            # one-hot contraction); the resident scan reads one [M, 256] LUT
            # row per live query slot, the dense one the expanded [W, tq, M, 256]
            nq_u = wmask.sum(axis=1)
            rows_u = valid_t.sum(dim=1).cpu().numpy()
            lut_bytes = int(nq_u.sum()) * M * NBOOK * 4 if resident else W * plan.tq * M * NBOOK * 4
            prof.record_dispatch(
                "scan", "pq-res" if resident else "pq", lp, t0,
                nbytes=lut_bytes + W * lp * M + W * lp + W * plan.tq * kk * 12,
                flops=2.0 * M * NBOOK * float((nq_u * rows_u).sum()),
                flops_padded=2.0 * M * NBOOK * W * plan.tq * lp,
                units=n_units, units_padded=W,
                rows=int(rows_u.sum()), rows_padded=W * lp,
            )
        wmask_t = torch.from_numpy(wmask).to(dev)
        yield kk, qrow_of[wmask], slot_of[wmask], s[wmask_t], _unit_rows(rows, i_loc)[wmask_t]


def _pq_stage_a_segmented(plan, arena, luts_dev, lut_pos, kprime, *, stats) -> torch.Tensor:
    """Segmented ADC stage A: flat [Σ seg_counts, k′] scatter + one ragged
    merge. Returns the surviving packed rows i64 [m, k′] (-1 pad) on the
    arena's device."""
    m = plan.m
    dev = arena.device
    counts = _plan_seg_counts(plan)  # stage A has no extras; they fold after the re-rank
    offsets = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    C_total = int(offsets[-1])
    C_pad = _next_pow2(C_total, 1)
    flat_s = torch.full((C_pad, kprime), -float("inf"), dtype=torch.float32, device=dev)
    flat_rows = torch.full((C_pad, kprime), -1, dtype=torch.int64, device=dev)
    seg_of = np.full(C_pad, m, dtype=np.int32)
    seg_of[:C_total] = np.repeat(np.arange(m, dtype=np.int32), counts)
    _account_candidates(stats, _nbytes(flat_s, flat_rows))

    for kk, qr, sl, s_w, rows_w in _iter_pq_buckets(
        plan, arena, luts_dev, lut_pos, kprime, resident=True, stats=stats
    ):
        rows_f = torch.from_numpy(offsets[qr] + sl).to(dev)
        flat_s[rows_f, :kk] = s_w
        flat_rows[rows_f, :kk] = rows_w

    prof = get_profiler()
    t0 = prof.t0() if prof.enabled else 0
    with get_tracer().span("merge.segmented", m=m, candidates=C_total):
        _, top_rows = kops.segmented_merge_topk(
            flat_s, flat_rows, torch.from_numpy(seg_of).to(dev), m, kprime
        )
        top_rows = fence(top_rows)
    if prof.enabled:
        prof.record_dispatch(
            "merge", "segmented", C_pad, t0,
            nbytes=_nbytes(flat_s, flat_rows) + seg_of.nbytes + m * kprime * 12,
            flops=0.0, flops_padded=0.0,
            units=m, units_padded=m,
            rows=C_total, rows_padded=C_pad,
        )
    return top_rows


def _pq_stage_a_dense(plan, arena, luts_dev, lut_pos, kprime, *, stats) -> torch.Tensor:
    """Dense ADC stage A: [m, n_slots, k′] scatter + rectangular merge.
    Returns the surviving packed rows i64 [m, k′] (-1 pad)."""
    m = plan.m
    dev = arena.device
    cand_s = torch.full((m, plan.n_slots, kprime), -float("inf"), dtype=torch.float32, device=dev)
    cand_rows = torch.full((m, plan.n_slots, kprime), -1, dtype=torch.int64, device=dev)
    _account_candidates(stats, _nbytes(cand_s, cand_rows))
    for kk, qr, sl, s_w, rows_w in _iter_pq_buckets(
        plan, arena, luts_dev, lut_pos, kprime, resident=False, stats=stats
    ):
        qr_t, sl_t = torch.from_numpy(qr).to(dev), torch.from_numpy(sl).to(dev)
        cand_s[qr_t, sl_t, :kk] = s_w
        cand_rows[qr_t, sl_t, :kk] = rows_w
    _, top_rows = _padded_merge(cand_s.reshape(m, -1), cand_rows.reshape(m, -1), kprime)
    return top_rows


def rerank_operands(arena: PackedArena, q_vecs: np.ndarray, rows: torch.Tensor, kprime: int):
    """The exact re-rank's operands: units are per query (TQ = 1), so each
    query re-scores only its own candidates; m pads to a power of two, as in
    the reference, and the padding units hold no query (``n_live`` 0).
    Returns (Q f32 [mp, 1, d], V f32 [mp, k′, d] gathered by one
    ``index_select``, valid bool [mp, k′], n_live i32 [mp])."""
    m, d = q_vecs.shape
    dev = arena.device
    mp = _next_pow2(m, 1)
    Qr = torch.zeros((mp, 1, d), dtype=torch.float32, device=dev)
    Qr[:m, 0] = torch.from_numpy(np.ascontiguousarray(q_vecs, dtype=np.float32)).to(dev)
    rows_p = torch.full((mp, kprime), -1, dtype=torch.int64, device=dev)
    rows_p[:m] = rows
    valid_r = rows_p >= 0
    Vr = arena.packed.index_select(0, rows_p.clamp(min=0).reshape(-1)).reshape(mp, kprime, d)
    n_live = (torch.arange(mp, device=dev) < m).to(torch.int32)
    return Qr, Vr, valid_r, n_live


def _pq_rerank_and_fold(
    arena: PackedArena,
    q_vecs: np.ndarray,
    rows: torch.Tensor,  # i64 [m, k′] surviving packed rows (-1 pad), on the arena's device
    *,
    k: int,
    kprime: int,
    extra: Sequence[ExtraCandidates],
    stats: Optional[ScanStats],
) -> Tuple[np.ndarray, np.ndarray]:
    """Stage B shared by both layouts: exact re-rank + extras fold.

    One gather of the surviving f32 rows and one dispatch
    (``rerank_operands``)."""
    m = q_vecs.shape[0]
    dev = arena.device
    Qr, Vr, valid_r, n_live = rerank_operands(arena, q_vecs, rows, kprime)
    if stats is not None:
        # real surviving candidates only
        stats.bytes_scanned += int(valid_r.sum()) * arena.d * 4
    prof = get_profiler()
    t0 = prof.t0() if prof.enabled else 0
    with get_tracer().span("rerank.exact", m=m, kprime=kprime):
        s, i_loc = kops.workunit_topk(Qr, Vr, valid_r, min(k, kprime), metric=arena.metric,
                                      n_live=n_live)
        s, i_loc = fence(s, i_loc)
    if prof.enabled:
        mp, d = Qr.shape[0], arena.d
        n_real = int(valid_r.sum())
        prof.record_dispatch(
            "rerank", "f32", kprime, t0,
            nbytes=_nbytes(Qr, Vr, valid_r) + mp * min(k, kprime) * 12,
            flops=2.0 * d * n_real,
            flops_padded=2.0 * d * mp * kprime,
            units=m, units_padded=mp,
            rows=n_real, rows_padded=mp * kprime,
        )
    s = s[:m, 0]  # [m, kk] exact scores
    i_loc = i_loc[:m, 0].to(torch.int64)  # [m, kk] index into the k′ candidates
    kk = s.shape[-1]
    packed_rows = torch.gather(rows, 1, i_loc.clamp(min=0))
    gidx = torch.where(
        (i_loc < 0) | (packed_rows < 0), -1, arena.gid[packed_rows.clamp(min=0)]
    )

    # final merge: re-ranked (exact) plan results in slot 0 + host-side exact
    # extras in the columns after it, the same tail as the f32 path
    n_slots = 1 + _extra_slot_width(extra, m)
    out_scores = torch.full((m, n_slots, k), -float("inf"), dtype=torch.float32, device=dev)
    out_idx = torch.full((m, n_slots, k), -1, dtype=torch.int64, device=dev)
    _account_candidates(stats, _nbytes(out_scores, out_idx))
    out_scores[:, 0, :kk] = torch.where(gidx >= 0, s, -float("inf"))
    out_idx[:, 0, :kk] = gidx
    return _fold_extras_and_merge(out_scores, out_idx, extra, 1, k)


# ----------------------------------------------------------------- sharded


@dataclasses.dataclass
class ShardStats:
    """Per-rank accounting of one sharded execution (the bench/test probe).

    ``per_rank_bytes`` counts arena bytes each rank's scan stages gathered
    for its REAL work units (stacking pad excluded) — the quantity that must
    shrink ~1/|model| per rank versus a single device. ``gathered_per_query``
    is the total candidate columns the gather merges moved per query:
    O(k · |model|) by construction, independent of DB size.
    """

    n_shards: int
    per_rank_bytes: np.ndarray  # i64 [R] — arena bytes scanned by rank r
    per_rank_units: np.ndarray  # i64 [R] — real work units executed by rank r
    per_rank_dispatches: np.ndarray  # i64 [R] — stages rank r had live work in
    gathered_per_query: int = 0  # candidate columns gathered per query

    @staticmethod
    def zeros(n_shards: int) -> "ShardStats":
        return ShardStats(
            n_shards=int(n_shards),
            per_rank_bytes=np.zeros(n_shards, dtype=np.int64),
            per_rank_units=np.zeros(n_shards, dtype=np.int64),
            per_rank_dispatches=np.zeros(n_shards, dtype=np.int64),
        )


def execute_plan_sharded(
    splan: ShardedPlan,
    sharded: ShardedArena,
    q_vecs: np.ndarray,  # f32 [m, d]
    *,
    mesh,
    axis: str = "model",
    cfg: Optional[PlanConfig] = None,
    extra: Sequence[ExtraCandidates] = (),
    stats: Optional[ScanStats] = None,
    shard_stats: Optional[ShardStats] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Stage 2 across a device mesh — bit-identical to ``execute_plan``.

    Per shared shape bucket, every rank's work units run in ONE
    ``sharded_workunit_topk`` (or ``_pq_topk``) dispatch: rank r gathers
    rows/codes only from ITS arena shard, so per-rank scan traffic is its
    shard's share of the workload. Candidates then reduce in two hops: a
    rank-local top-k over each rank's own candidates, followed by the gather
    merge (``sharded_merge_topk``) whose traffic is k·|model| (score, id)
    pairs per query. Extras (the adaptive executor's host-side exact scans)
    fold into the final merge exactly like the single-device paths.

    Parity: every (query, posting-list) pair lives on exactly one rank and is
    scored by the same per-unit kernel as on a single device, so the union of
    per-rank candidates is the single-device candidate set and the two-hop
    top-k selects the same result. Caveat, as in the reference: candidates
    with EXACTLY equal scores straddling the k (or k′) boundary may resolve
    in another order than the single-device flat merge (the two layouts
    order candidates differently); on continuous data exact ties are
    duplicate vectors.
    """
    cfg = PlanConfig() if cfg is None else cfg
    if cfg.scan_mode not in ("f32", "pq"):
        raise ValueError(f"unknown scan_mode {cfg.scan_mode!r}")
    if cfg.merge_layout not in ("segmented", "dense"):
        raise ValueError(f"unknown merge_layout {cfg.merge_layout!r}")
    sstats = ShardStats.zeros(sharded.n_shards) if shard_stats is None else shard_stats
    sstats.per_rank_units += splan.per_rank_units
    m, k = splan.plan.m, splan.plan.k
    if m == 0 or splan.n_units == 0:
        n_slots = _extra_slot_width(extra, m)
        if m == 0 or n_slots == 0:
            return (
                np.full((m, k), -np.inf, np.float32),
                np.full((m, k), -1, np.int64),
            )
        dev0 = sharded.devices[0]
        out_scores = torch.full((m, n_slots, k), -float("inf"), dtype=torch.float32, device=dev0)
        out_idx = torch.full((m, n_slots, k), -1, dtype=torch.int64, device=dev0)
        return _fold_extras_and_merge(out_scores, out_idx, extra, 0, k)
    if cfg.scan_mode == "pq":
        if sharded.base.codes is None or sharded.base.pq is None:
            raise ValueError(
                "scan_mode='pq' needs a PQ-encoded arena: build the HQIIndex "
                "with HQIConfig(scan_mode='pq') or attach_pq() a codebook, or "
                "pass pq= to batch_search_ivf"
            )
        return _execute_sharded_pq(
            splan, sharded, q_vecs, mesh=mesh, axis=axis, cfg=cfg,
            extra=extra, stats=stats, sstats=sstats,
        )
    return _execute_sharded_f32(
        splan, sharded, q_vecs, mesh=mesh, axis=axis, cfg=cfg,
        extra=extra, stats=stats, sstats=sstats,
    )


def _on_devices(x: torch.Tensor, devices: Sequence[torch.device]) -> Dict[torch.device, torch.Tensor]:
    """One copy of ``x`` per distinct device (a replicated operand)."""
    return {dev: x if x.device == dev else x.to(dev) for dev in dict.fromkeys(devices)}


def _merge_with_extras(
    ms: torch.Tensor,  # f32 [m, k] — the gather merge's final top-k
    mi: torch.Tensor,  # i64 [m, k]
    extra: Sequence[ExtraCandidates],
    k: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Shared tail of both sharded scan modes: fold the adaptive executor's
    host-side exact candidates (if any) into the merged device result —
    slot 0 holds the sharded top-k, extras take the columns after it."""
    if not extra:
        return ms.cpu().numpy(), mi.cpu().numpy()
    m = ms.shape[0]
    out_slots = 1 + _extra_slot_width(extra, m)
    out_scores = torch.full((m, out_slots, k), -float("inf"), dtype=torch.float32, device=ms.device)
    out_idx = torch.full((m, out_slots, k), -1, dtype=torch.int64, device=ms.device)
    out_scores[:, 0] = ms
    out_idx[:, 0] = mi
    return _fold_extras_and_merge(out_scores, out_idx, extra, 1, k)


def _gather_merge(
    mesh,
    axis: str,
    cand_s: Sequence[torch.Tensor],  # per rank: f32 [m, n_slots, kk] on its device
    cand_i: Sequence[torch.Tensor],  # per rank: i64 [m, n_slots, kk]
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-hop reduction: rank-local top-k, then the k·|model| gather merge.
    Candidate width pads pow2 (≥ k) with (-inf, -1), like the single-device
    ``_padded_merge``. Returns (scores, ids) [m, k] on the first rank's
    device, absent entries (-inf, -1)."""
    R, m = len(cand_s), cand_s[0].shape[0]
    flat_s = [c.reshape(m, -1) for c in cand_s]
    flat_i = [c.reshape(m, -1) for c in cand_i]
    real_width = flat_s[0].shape[1]
    width = _next_pow2(real_width, k)
    if width > real_width:
        padc = width - real_width
        flat_s = [torch.nn.functional.pad(t, (0, padc), value=-float("inf")) for t in flat_s]
        flat_i = [torch.nn.functional.pad(t, (0, padc), value=-1) for t in flat_i]
    prof = get_profiler()
    t0 = prof.t0() if prof.enabled else 0
    with get_tracer().span("merge.gather", ranks=R, m=m, width=width):
        ms, mi = kops.sharded_merge_topk(mesh, axis, flat_s, flat_i, k)
        ms, mi = fence(ms, mi)
    if prof.enabled:
        prof.record_dispatch(
            "gather", "sharded", width, t0,
            nbytes=R * m * width * 12 + m * k * 12,
            flops=0.0, flops_padded=0.0,
            units=R * m, units_padded=R * m,
            rows=R * m * real_width, rows_padded=R * m * width,
        )
    return ms, mi


def _rank_segments(keys: Sequence[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """One rank's CSR layout for the sharded segmented merge, from its
    candidates' ``q · S + slot`` keys in the order the executor met them.

    Every (query, slot) pair lives in exactly one work unit, hence on exactly
    one rank, so a rank's keys are distinct and its candidate rows are their
    sorted set. Returns (row i64 of each key, in the given order; the keys
    sorted): row j belongs to query ``sorted[j] // S``, ascending.
    """
    if not keys:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    flat = np.concatenate(keys)
    order = np.argsort(flat)  # distinct keys: no tie to keep
    row = np.empty_like(order)
    row[order] = np.arange(len(order))
    return row, flat[order]


class _RankCandidates:
    """One sharded stage's candidate buffers and their two-hop reduction.

    Segmented layout: ranks' per-unit top-ks are held as they come, then
    each device lays its ranks' rows out in ONE flat [C_pad, kk] buffer (rank
    r's from an offset, in ``_rank_segments`` order) with segment j·m + q for
    the device's j-th rank and query q, so one ragged merge per device gives
    each of its ranks' local [m, kk] top-k — with every rank on one device,
    the reference's one merge over R·m segments. Dense layout: rank r's
    [m, n_slots, kk] tensor on its device.
    """

    def __init__(self, splan: ShardedPlan, sharded: ShardedArena, width: int, *,
                 segmented: bool, stats: Optional[ScanStats]):
        m = splan.plan.m
        self.m, self.width, self.segmented, self.stats = m, width, segmented, stats
        self.S = max(splan.plan.n_slots, 1)
        self.devices = sharded.devices
        self.groups: Dict[torch.device, List[int]] = {}
        for r, dev in enumerate(self.devices):
            self.groups.setdefault(dev, []).append(r)
        if segmented:
            self.held: List[list] = [[] for _ in self.devices]
        else:
            n_slots = splan.plan.n_slots
            self.cand = [
                (torch.full((m, n_slots, width), -float("inf"), dtype=torch.float32, device=dev),
                 torch.full((m, n_slots, width), -1, dtype=torch.int64, device=dev))
                for dev in self.devices
            ]
            _account_candidates(stats, sum(_nbytes(*c) for c in self.cand))

    def put(self, r: int, qr: np.ndarray, sl: np.ndarray, kk: int,
            s_w: torch.Tensor, i_w: torch.Tensor) -> None:
        """Rank r's per-unit top-kk of its real slots (query rows ``qr``,
        merge slots ``sl``)."""
        if self.segmented:
            self.held[r].append((qr * self.S + sl, kk, s_w, i_w))
            return
        dev = self.devices[r]
        cand_s, cand_i = self.cand[r]
        qr_t, sl_t = torch.from_numpy(qr).to(dev), torch.from_numpy(sl).to(dev)
        cand_s[qr_t, sl_t, :kk] = s_w
        cand_i[qr_t, sl_t, :kk] = i_w

    def _lay_out(self, dev: torch.device, ranks: List[int]):
        """The device's flat buffers and segment ids, filled from its ranks'
        held top-ks."""
        m, width = self.m, self.width
        placed, segs, off = [], [], 0
        for j, r in enumerate(ranks):
            row, keys = _rank_segments([h[0] for h in self.held[r]])
            placed.append((r, off + row))
            segs.append(j * m + keys // self.S)
            off += len(keys)
        C_pad = _next_pow2(off, 1)
        seg_of = np.full(C_pad, len(ranks) * m, dtype=np.int32)  # pad rows: dropped
        seg_of[:off] = np.concatenate(segs)
        flat_s = torch.full((C_pad, width), -float("inf"), dtype=torch.float32, device=dev)
        flat_i = torch.full((C_pad, width), -1, dtype=torch.int64, device=dev)
        for r, rows in placed:
            a = 0
            for keys, kk, s_w, i_w in self.held[r]:
                rows_t = torch.from_numpy(rows[a:a + len(keys)]).to(dev)
                flat_s[rows_t, :kk] = s_w
                flat_i[rows_t, :kk] = i_w
                a += len(keys)
            self.held[r] = []
        return flat_s, flat_i, seg_of, off

    def reduce(self, mesh, axis: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """Rank-local top-``width``, then the gather merge: [m, width] on the
        first rank's device."""
        if not self.segmented:
            return _gather_merge(mesh, axis, [c[0] for c in self.cand],
                                 [c[1] for c in self.cand], self.width)
        m, width = self.m, self.width
        per_s: List[Optional[torch.Tensor]] = [None] * len(self.devices)
        per_i: List[Optional[torch.Tensor]] = [None] * len(self.devices)
        bufs = {dev: self._lay_out(dev, ranks) for dev, ranks in self.groups.items()}
        _account_candidates(self.stats, sum(_nbytes(b[0], b[1]) for b in bufs.values()))
        prof = get_profiler()
        for dev, ranks in self.groups.items():
            flat_s, flat_i, seg_of, C_total = bufs[dev]
            n_seg = len(ranks) * m
            t0 = prof.t0() if prof.enabled else 0
            with get_tracer().span("merge.segmented", m=n_seg, candidates=C_total):
                seg_s, seg_i = kops.segmented_merge_topk(
                    flat_s, flat_i, torch.from_numpy(seg_of).to(dev), n_seg, width
                )
                seg_s, seg_i = fence(seg_s, seg_i)
            if prof.enabled:
                prof.record_dispatch(
                    "merge", "segmented", flat_s.shape[0], t0,
                    nbytes=_nbytes(flat_s, flat_i) + seg_of.nbytes + n_seg * width * 12,
                    flops=0.0, flops_padded=0.0,
                    units=n_seg, units_padded=n_seg,
                    rows=C_total, rows_padded=flat_s.shape[0],
                )
            for j, r in enumerate(ranks):
                per_s[r] = seg_s[j * m:(j + 1) * m].reshape(m, 1, width)
                per_i[r] = seg_i[j * m:(j + 1) * m].reshape(m, 1, width)
        return _gather_merge(mesh, axis, per_s, per_i, width)


def _record_sharded_scan(prof, mode: str, lp: int, t0: int, *, R: int, W: int, tq: int,
                         kk: int, ops_: list, nbytes: int, pair_flops: float,
                         rank_units: List[int], rank_bytes: List[int]) -> None:
    """The reference's profiler row of one sharded scan dispatch, from its
    stacked [R, W, ...] shapes; ``ops_[r]`` is rank r's bucket operands (or
    None), whose ``qrow_of`` and ``valid`` give the real pairs and rows."""
    pairs = rows = 0
    for o in ops_:
        if o is None:
            continue
        nq_w = (o[0] >= 0).sum(axis=1)
        rows_w = o[5].sum(dim=1).cpu().numpy()
        pairs += int((nq_w * rows_w).sum())
        rows += int(rows_w.sum())
    prof.record_dispatch(
        "scan", mode, lp, t0,
        nbytes=nbytes + R * W * tq * kk * 12,
        flops=pair_flops * pairs,
        flops_padded=pair_flops * R * W * tq * lp,
        units=int(sum(rank_units)), units_padded=R * W,
        rows=rows, rows_padded=R * W * lp,
        rank_units=rank_units,
        rank_bytes=rank_bytes,
    )


def _execute_sharded_f32(
    splan: ShardedPlan,
    sharded: ShardedArena,
    q_vecs: np.ndarray,
    *,
    mesh,
    axis: str,
    cfg: PlanConfig,
    extra: Sequence[ExtraCandidates],
    stats: Optional[ScanStats],
    sstats: ShardStats,
) -> Tuple[np.ndarray, np.ndarray]:
    R = sharded.n_shards
    plan = splan.plan
    k, tq = plan.k, plan.tq
    d = q_vecs.shape[1]
    arena = sharded.base
    shards = [sharded.rank(r) for r in range(R)]
    q_on = _on_devices(torch.from_numpy(np.ascontiguousarray(q_vecs, dtype=np.float32)),
                       sharded.devices)
    cands = _RankCandidates(splan, sharded, k, segmented=cfg.merge_layout == "segmented",
                            stats=stats)
    prof = get_profiler()
    for lp in splan.pads:
        unit_lists = [splan.rank_buckets[r].get(lp, []) for r in range(R)]
        W = _next_pow2(max(len(u) for u in unit_lists), 1)
        ops_: list = [None] * R
        for r, units in enumerate(unit_lists):
            if not units:
                continue
            sh = shards[r]
            ops_[r] = bucket_operands(plan, arena, q_on[sh.device], lp,
                                      units=units, w_pad=len(units), shard=sh)
            sstats.per_rank_bytes[r] += len(units) * lp * d * 4
            sstats.per_rank_dispatches[r] += 1
        rank_units = [len(u) for u in unit_lists]
        if stats is not None:
            stats.bytes_scanned += sum(rank_units) * lp * d * 4
        kk = min(k, lp)
        t0 = prof.t0() if prof.enabled else 0
        with get_tracer().span("dispatch.sharded", mode="f32", lp=lp, rank_units=rank_units):
            res = kops.sharded_workunit_topk(
                mesh, axis,
                [o and o[3] for o in ops_], [o and o[4] for o in ops_], [o and o[5] for o in ops_],
                kk, metric=arena.metric,
                n_live=[o and live_slots(o[0], o[3].device) for o in ops_],
            )
            fence(*[t for pair in res if pair is not None for t in pair])
        if prof.enabled:
            _record_sharded_scan(
                prof, "sharded-f32", lp, t0, R=R, W=W, tq=tq, kk=kk, ops_=ops_,
                nbytes=R * W * tq * d * 4 + R * W * lp * d * 4 + R * W * lp,
                pair_flops=2.0 * d, rank_units=rank_units,
                rank_bytes=[n * lp * d * 4 for n in rank_units],
            )
        for r, pair in enumerate(res):
            if pair is None:
                continue
            qrow_of, slot_of, rows = ops_[r][:3]
            s, i_loc = pair
            local = _unit_rows(rows, i_loc)
            gidx = torch.where(local < 0, -1, shards[r].gid[local.clamp(min=0)])
            wmask = qrow_of >= 0
            wmask_t = torch.from_numpy(wmask).to(s.device)
            cands.put(r, qrow_of[wmask], slot_of[wmask], s.shape[-1], s[wmask_t], gidx[wmask_t])
    ms, mi = cands.reduce(mesh, axis)
    sstats.gathered_per_query += R * k
    return _merge_with_extras(ms, mi, extra, k)


def _execute_sharded_pq(
    splan: ShardedPlan,
    sharded: ShardedArena,
    q_vecs: np.ndarray,
    *,
    mesh,
    axis: str,
    cfg: PlanConfig,
    extra: Sequence[ExtraCandidates],
    stats: Optional[ScanStats],
    sstats: ShardStats,
) -> Tuple[np.ndarray, np.ndarray]:
    """Compressed two-stage execution across the mesh.

    Stage A mirrors the f32 path with uint8 code tiles: per shared bucket,
    one sharded ADC dispatch; each rank keeps k′ = refine_factor · k ADC
    candidates per (query, posting list) as GLOBAL packed rows. The ADC
    candidate gather (k′·|model| per query) then selects the same global
    top-k′ the single-device merge would — any global survivor is also a
    local survivor on its rank — and stage B re-ranks exactly
    (``_sharded_rerank``). Extras fold in last, as everywhere.
    """
    R = sharded.n_shards
    plan = splan.plan
    k, tq = plan.k, plan.tq
    arena = sharded.base
    M = arena.pq.m
    kprime = max(k, int(cfg.refine_factor) * k)
    shards = [sharded.rank(r) for r in range(R)]
    segmented = cfg.merge_layout == "segmented"

    luts_dev, lut_pos = resident_luts(plan, arena, q_vecs)
    _account_lut(stats, _nbytes(luts_dev), expanded=False)
    luts_on = _on_devices(luts_dev, sharded.devices)  # the table, replicated
    cands = _RankCandidates(splan, sharded, kprime, segmented=segmented, stats=stats)
    prof = get_profiler()
    for lp in splan.pads:
        unit_lists = [splan.rank_buckets[r].get(lp, []) for r in range(R)]
        W = _next_pow2(max(len(u) for u in unit_lists), 1)
        ops_: list = [None] * R
        for r, units in enumerate(unit_lists):
            if not units:
                continue
            ops_[r] = pq_bucket_operands(plan, arena, lut_pos, lp,
                                         units=units, w_pad=len(units), shard=shards[r])
            sstats.per_rank_bytes[r] += len(units) * lp * M
            sstats.per_rank_dispatches[r] += 1
        rank_units = [len(u) for u in unit_lists]
        if stats is not None:
            stats.bytes_scanned += sum(rank_units) * lp * M
        kk = min(kprime, lp)
        if not segmented:
            # the dense dispatch expands every rank's [W_r, tq, M, 256] LUT
            # operands; the segmented one reads the resident table
            _account_lut(stats, sum(rank_units) * tq * M * NBOOK * 4, expanded=True)
        t0 = prof.t0() if prof.enabled else 0
        with get_tracer().span("dispatch.sharded", mode="pq", lp=lp, rank_units=rank_units):
            res = kops.sharded_workunit_pq_topk(
                mesh, axis,
                [luts_on[dev] for dev in sharded.devices],
                [o and o[3] for o in ops_], [o and o[4] for o in ops_], [o and o[5] for o in ops_],
                kk, stream=segmented,
                n_live=None if segmented else [o and live_slots(o[0], o[3].device) for o in ops_],
            )
            fence(*[t for pair in res if pair is not None for t in pair])
        if prof.enabled:
            n_slots_live = sum(int((o[0] >= 0).sum()) for o in ops_ if o is not None)
            lut_b = n_slots_live * M * NBOOK * 4 if segmented else R * W * tq * M * NBOOK * 4
            _record_sharded_scan(
                prof, "sharded-pq", lp, t0, R=R, W=W, tq=tq, kk=kk, ops_=ops_,
                nbytes=R * W * lp * M + R * W * lp + lut_b,
                pair_flops=2.0 * M * NBOOK, rank_units=rank_units,
                rank_bytes=[n * lp * M for n in rank_units],
            )
        for r, pair in enumerate(res):
            if pair is None:
                continue
            qrow_of, slot_of, rows = ops_[r][:3]
            s, i_loc = pair
            local = _unit_rows(rows, i_loc)
            grow = torch.where(local < 0, -1, local + shards[r].row0)  # global packed rows
            wmask = qrow_of >= 0
            wmask_t = torch.from_numpy(wmask).to(s.device)
            cands.put(r, qrow_of[wmask], slot_of[wmask], s.shape[-1], s[wmask_t], grow[wmask_t])
    # global top-k′ ADC candidates: the same selection as the single-device
    # merge (a global survivor survives on its rank too)
    _, top_rows = cands.reduce(mesh, axis)  # [m, k′] global rows (-1 pad), rank 0's device
    sstats.gathered_per_query += R * kprime
    return _sharded_rerank(mesh, axis, sharded, q_vecs, top_rows, k=k, kprime=kprime,
                           extra=extra, stats=stats, sstats=sstats)


def _sharded_rerank(mesh, axis: str, sharded: ShardedArena, q_vecs: np.ndarray,
                    top_rows: torch.Tensor, *, k: int, kprime: int,
                    extra: Sequence[ExtraCandidates], stats: Optional[ScanStats],
                    sstats: ShardStats) -> Tuple[np.ndarray, np.ndarray]:
    """Stage B across the mesh: rank r rescans the surviving rows IT stores
    (``owner_of_row``; units of one query as in ``rerank_operands``, the
    other ranks' rows masked) in one sharded dispatch, then the k·|model|
    gather merge of the partial exact top-ks and the extras. A rank that
    stores no survivor launches nothing and gives (-inf, -1); every unit of
    stage A holds a valid row (``build_plan`` drops lists the bitmap
    empties), so some rank always stores one."""
    R = sharded.n_shards
    m, d = q_vecs.shape
    mp = _next_pow2(m, 1)
    kk = min(k, kprime)
    owner = torch.searchsorted(
        torch.from_numpy(sharded.row_bounds).to(top_rows.device), top_rows.clamp(min=0), right=True
    ) - 1
    owner = torch.where(top_rows >= 0, owner, -1)  # an absent candidate (-1) goes nowhere
    q_on = _on_devices(torch.from_numpy(np.ascontiguousarray(q_vecs, dtype=np.float32)),
                       sharded.devices)
    operands: list = [None] * R
    n_real = 0
    for r in range(R):
        sh = sharded.rank(r)
        own = owner == r
        n_own = int(own.sum())
        if n_own == 0:
            continue
        dev = sh.device
        own, rows = own.to(dev), top_rows.to(dev)
        rows_p = torch.zeros((mp, kprime), dtype=torch.int64, device=dev)
        rows_p[:m] = torch.where(own, rows - sh.row0, 0)
        valid = torch.zeros((mp, kprime), dtype=torch.bool, device=dev)
        valid[:m] = own
        Qr = torch.zeros((mp, 1, d), dtype=torch.float32, device=dev)
        Qr[:m, 0] = q_on[dev]
        Vr = sh.packed.index_select(0, rows_p.reshape(-1)).reshape(mp, kprime, d)
        n_live = (torch.arange(mp, device=dev) < m).to(torch.int32)
        operands[r] = (Qr, Vr, valid, n_live, rows)
        sstats.per_rank_bytes[r] += n_own * d * 4
        sstats.per_rank_dispatches[r] += 1
        n_real += n_own
    if stats is not None:
        stats.bytes_scanned += n_real * d * 4
    prof = get_profiler()
    t0 = prof.t0() if prof.enabled else 0
    with get_tracer().span("rerank.exact", mode="sharded", m=m, kprime=kprime):
        res = kops.sharded_workunit_topk(
            mesh, axis, [o and o[0] for o in operands], [o and o[1] for o in operands],
            [o and o[2] for o in operands], kk, metric=sharded.base.metric,
            n_live=[o and o[3] for o in operands],
        )
        fence(*[t for pair in res if pair is not None for t in pair])
    if prof.enabled:
        prof.record_dispatch(
            "rerank", "sharded", kprime, t0,
            nbytes=R * mp * d * 4 + R * mp * kprime * d * 4 + R * mp * kprime + R * mp * kk * 12,
            flops=2.0 * d * n_real,
            flops_padded=2.0 * d * R * mp * kprime,
            units=m, units_padded=R * mp,
            rows=n_real, rows_padded=R * mp * kprime,
        )
    part_s, part_i = [], []
    for r, pair in enumerate(res):
        sh = sharded.rank(r)
        if pair is None:
            part_s.append(torch.full((m, 1, kk), -float("inf"), dtype=torch.float32, device=sh.device))
            part_i.append(torch.full((m, 1, kk), -1, dtype=torch.int64, device=sh.device))
            continue
        s = pair[0][:m, 0]  # [m, kk] exact partial scores
        i_loc = pair[1][:m, 0].to(torch.int64)  # [m, kk] index into the k′ candidates
        grow = torch.gather(operands[r][4], 1, i_loc.clamp(min=0))
        gidx = torch.where(
            (i_loc < 0) | (grow < 0), -1, sh.gid[(grow - sh.row0).clamp(0, max(sh.n - 1, 0))]
        )
        part_s.append(torch.where(gidx >= 0, s, -float("inf"))[:, None, :])
        part_i.append(gidx[:, None, :])
    ms, mi = _gather_merge(mesh, axis, part_s, part_i, k)
    sstats.gathered_per_query += R * k
    return _merge_with_extras(ms, mi, extra, k)


def batch_search_ivf(
    ivf: IVFIndex,
    q_vecs: np.ndarray,  # [m, d] — one template group
    *,
    nprobe: int,
    k: int,
    bitmap: Optional[np.ndarray] = None,  # bool [n] in LOCAL vector order
    stats: Optional[ScanStats] = None,
    cfg: Optional[PlanConfig] = None,
    pq: Optional[PQCodebook] = None,  # required iff cfg.scan_mode == "pq"
    mesh=None,  # launch.mesh.Mesh: shard the scan over its model axis
    shard_spec=None,  # core.distributed.ShardSpec (default axes)
) -> Tuple[np.ndarray, np.ndarray]:
    """Plan + execute one IVF index on its device: (scores f32 [m, k], local
    idx i64 [m, k]).

    With ``mesh=`` the index is one partition spread over the model axis's
    ranks at posting-list boundaries (``PackedArena.sharded_from_ivf``) and
    executes through ``core.distributed.execute_sharded``; the results are
    bit-identical to ``mesh=None``."""
    cfg = PlanConfig() if cfg is None else cfg
    m = q_vecs.shape[0]
    if m == 0:
        return np.zeros((0, k), np.float32), np.zeros((0, k), np.int64)
    arena = PackedArena.from_ivf(ivf)
    if cfg.scan_mode == "pq":
        # an explicit codebook per call: the arena is memoized on the IVF, so
        # falling back to arena.pq would reuse whatever a previous caller
        # attached (attach_pq skips the re-encode for the same codebook)
        if pq is None:
            raise ValueError("batch_search_ivf(scan_mode='pq') needs an explicit pq=")
        arena.attach_pq(pq)
    packed_bitmap = None if bitmap is None else arena.packed_bitmap(0, bitmap)
    task = EngineTask(
        part=0,
        qrows=np.arange(m, dtype=np.int64),
        nprobe=int(min(nprobe, ivf.n_lists)),
        packed_bitmap=packed_bitmap,
    )
    if mesh is not None:
        from .distributed import ShardSpec, execute_sharded

        spec = shard_spec or ShardSpec()
        sharded = PackedArena.sharded_from_ivf(ivf, spec.n_shards(mesh), spec.rank_devices(mesh))
        s, i, _ = execute_sharded(
            sharded, [task], q_vecs,
            mesh=mesh, spec=spec, m=m, k=k, cfg=cfg, stats=stats,
        )
        return s, i
    plan = build_plan(arena, [task], q_vecs, m=m, k=k, cfg=cfg, stats=stats)
    return execute_plan(plan, arena, q_vecs, cfg=cfg, stats=stats)
