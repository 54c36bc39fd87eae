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

``batch_search_ivf`` is the single-index entry point (the baselines use it):
a one-partition arena, a one-task plan, executed here. The sharded executor
is not ported yet (ROADMAP.md §1, sharded engine). Every dispatch and merge
sits in a tracer span and, while a profiler is enabled (``obs.profile``),
records the reference's shape facts (bytes, FLOPs, units, rows, each real
and padded), computed from the padded bucket shapes by the reference's
formulas, so both packages record equal rows for the same plan.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops as kops
from ..kernels.pq_scan import NBOOK
from ..obs.profile import get_profiler
from ..obs.trace import fence, get_tracer
from .arena import PackedArena
from .ivf import IVFIndex, ScanStats
from .plan import EngineTask, ExecutionPlan, PlanConfig, WorkUnit, _next_pow2, build_plan
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
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Scan-stage assembly for one shape bucket (host numpy).

    Returns (Vrows i64 [W, lp] packed rows to gather, valid bool [W, lp],
    qrow_of i64 [W, tq] workload query row per unit slot (-1 pad),
    slot_of i64 [W, tq] merge-tensor slot per unit slot). W is the unit count
    padded to a power of two, as in the reference, so the dispatch shapes
    (``DispatchStats.shapes``) agree; padding units are fully masked.
    """
    tq = plan.tq
    n_packed = arena.n
    W = _next_pow2(len(units), 1)
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


def bucket_operands(plan: ExecutionPlan, arena: PackedArena, q_dev: torch.Tensor, lp: int):
    """One bucket's scan operands on the arena's device.

    Returns (qrow_of i64 [W, tq] host, slot_of i64 [W, tq] host, rows
    [W, lp] packed rows, Q [W, tq, d] with padding slots zeroed, V [W, lp, d]
    gathered by one ``index_select``, valid bool [W, lp]).
    """
    Vrows, valid, qrow_of, slot_of = _assemble_bucket(plan.buckets[lp], lp, plan, arena)
    dev = arena.device
    rows = torch.from_numpy(Vrows).to(dev)
    qrow_t = torch.from_numpy(qrow_of).to(dev)
    Q = q_dev[qrow_t.clamp(min=0)]
    Q = torch.where((qrow_t >= 0)[..., None], Q, torch.zeros((), device=dev))
    V = arena.packed.index_select(0, rows.reshape(-1)).reshape(Vrows.shape[0], lp, arena.d)
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


def pq_bucket_operands(plan: ExecutionPlan, arena: PackedArena, lut_pos: np.ndarray, lp: int):
    """One bucket's ADC scan operands on the arena's device.

    Returns (qrow_of i64 [W, tq] host, slot_of i64 [W, tq] host, rows [W, lp]
    packed rows, lut_idx i32 [W, tq] row of the resident LUT table per slot
    (``lut_pos`` of its query; -1 for a padding slot, which the resident
    kernel never scores: ``repro`` points it at row 0, and both engines drop
    its output), codes uint8 [W, lp, M] gathered by one ``index_select``,
    valid bool [W, lp]).
    """
    Vrows, valid, qrow_of, slot_of = _assemble_bucket(plan.buckets[lp], lp, plan, arena)
    dev = arena.device
    rows = torch.from_numpy(Vrows).to(dev)
    lut_idx = torch.from_numpy(np.where(qrow_of >= 0, lut_pos[np.maximum(qrow_of, 0)], -1)
                               .astype(np.int32)).to(dev)
    codes = arena.codes.index_select(0, rows.reshape(-1)).reshape(Vrows.shape[0], lp, arena.pq.m)
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
) -> Tuple[np.ndarray, np.ndarray]:
    """Plan + execute one IVF index on its device: (scores f32 [m, k], local
    idx i64 [m, k])."""
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
    plan = build_plan(arena, [task], q_vecs, m=m, k=k, cfg=cfg, stats=stats)
    return execute_plan(plan, arena, q_vecs, cfg=cfg, stats=stats)
