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

Only ``scan_mode="f32"`` runs here; the compressed path and the sharded
executor are not ported yet (ROADMAP.md §1 items 4 and 9). The reference's
per-dispatch profiler records return with the port of ``obs/profile.py``
(item 7); the tracer spans are kept.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops as kops
from ..kernels.fused_knn import check_kernel_limits
from ..obs.trace import fence, get_tracer
from .arena import PackedArena
from .ivf import ScanStats
from .plan import ExecutionPlan, PlanConfig, WorkUnit, _next_pow2
from .pq import PQ_NOT_PORTED

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
    if cfg.scan_mode == "pq":
        raise NotImplementedError(PQ_NOT_PORTED)
    if cfg.scan_mode != "f32":
        raise ValueError(f"unknown scan_mode {cfg.scan_mode!r}")
    if cfg.merge_layout not in ("segmented", "dense"):
        raise ValueError(f"unknown merge_layout {cfg.merge_layout!r}")
    m, k = plan.m, plan.k
    # extras get per-query-dense slot columns after the plan's own slots
    n_slots = plan.n_slots + _extra_slot_width(extra, m)
    if m == 0 or n_slots == 0:
        return (
            np.full((m, k), -np.inf, np.float32),
            np.full((m, k), -1, np.int64),
        )
    dev = arena.device if arena is not None else torch.device(device or "cuda")
    if plan.buckets and dev.type == "cuda":  # fail before any bucket is assembled
        check_kernel_limits(min(k, max(plan.buckets)), arena.d, plan.tq)
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


def _iter_f32_buckets(plan, arena, q_vecs, stats):
    """Run the f32 scan stage bucket by bucket (one ``workunit_topk`` dispatch
    each), yielding (kk, qrows, slots, scores [n, kk], gids [n, kk]) for the
    real unit slots: host index arrays, device result tensors. The scatter
    destination is the only thing the dense and segmented layouts disagree
    on, so the scan lives here once."""
    if not plan.buckets:
        return
    dev = arena.device
    q_dev = torch.from_numpy(np.ascontiguousarray(q_vecs, dtype=np.float32)).to(dev)
    for lp in sorted(plan.buckets):
        n_units = len(plan.buckets[lp])
        qrow_of, slot_of, rows, Q, V, valid = bucket_operands(plan, arena, q_dev, lp)
        if stats is not None:
            # real work units only (pow2 pad excluded)
            stats.bytes_scanned += n_units * lp * arena.d * 4
        with get_tracer().span("dispatch.scan", mode="f32", lp=lp, units=n_units):
            s, i_loc = kops.workunit_topk(Q, V, valid, min(plan.k, lp), metric=arena.metric)
            s, i_loc = fence(s, i_loc)  # device time is real iff tracing is on
        i_loc = i_loc.to(torch.int64)  # index within the unit's lp rows (-1 = none)
        packed_rows = torch.gather(rows[:, None, :].expand(-1, plan.tq, -1), 2, i_loc.clamp(min=0))
        gidx = torch.where(i_loc < 0, -1, arena.gid[packed_rows])
        wmask = qrow_of >= 0  # [W, tq]
        wmask_t = torch.from_numpy(wmask).to(dev)
        yield s.shape[-1], qrow_of[wmask], slot_of[wmask], s[wmask_t], gidx[wmask_t]


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

    with get_tracer().span("merge.segmented", m=m, candidates=C_total):
        top_s, top_i = kops.segmented_merge_topk(
            flat_s, flat_i, torch.from_numpy(seg_of).to(dev), m, k
        )
        top_s, top_i = fence(top_s, top_i)
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
    with get_tracer().span("merge.final", m=flat_s.shape[0], width=width):
        s, i = kops.merge_topk(flat_s, flat_i, k)
        s, i = fence(s, i)
    return s, i
