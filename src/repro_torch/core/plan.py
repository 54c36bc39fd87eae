"""Stage 1 of the execution engine: one global plan for the whole workload.

The old path walked a Python loop over every (template × partition) pair and
packed work units separately for each, so host-side packing, kernel dispatch
count, and XLA compile-cache pressure all scaled with T×L. ``build_plan``
instead takes every routed (template × partition) product as an
``EngineTask`` and buckets ALL resulting (query-chunk × posting-list) work
units *globally* by padded shape — posting lists from different partitions
and templates land in the same bucket whenever their padded length matches,
and each bucket later executes as ONE kernel dispatch (planner.py).

The plan is host numpy; only its execution touches the device.

Addressing is index-wide: work units reference posting lists by their global
id in a ``PackedArena``, so a single gather serves every partition.

``PlanConfig.max_bucket_shapes`` is the compile-shape budget: when the
workload would need more distinct padded lengths than that, the smallest pads
are rounded up into the surviving ladder, so the number of kernel shapes
(and dispatches) is bounded regardless of workload shape.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from .arena import PackedArena, ShardedArena
from .ivf import ScanStats


def _next_pow2(x: int, lo: int = 32) -> int:
    return max(lo, 1 << max(0, x - 1).bit_length())


@dataclasses.dataclass
class PlanConfig:
    tq_unit: int = 64  # queries per work unit
    min_list_pad: int = 32  # smallest padded list bucket
    max_bucket_shapes: int = 8  # compile-shape budget: max distinct padded lengths
    # accepted so that a reference index's saved state loads; ignored here:
    # the device of the tensors decides (CUDA kernel or plain PyTorch)
    use_pallas: Optional[bool] = None
    interpret: Optional[bool] = None
    # adaptive executor (paper §6.5): below this group size the per-query
    # scan beats batched matmuls (Fig. 7a's crossover ≈ 100 at paper scale)
    adaptive_crossover: int = 64
    # compressed execution: "f32" streams raw vectors (exact); "pq" runs the
    # two-stage ADC scan -> exact re-rank over the arena's uint8 PQ codes,
    # cutting scan HBM traffic by d·4/M× at a small recall cost
    scan_mode: str = "f32"
    # ADC candidates kept per query = refine_factor · k; the exact re-rank
    # recovers recall lost to quantization (FAISS's "refine" stage)
    refine_factor: int = 4
    # candidate merge layout: "segmented" (default) scatters per-unit top-ks
    # into a flat CSR-style [Σ segments, k] buffer reduced by one ragged
    # merge — peak merge memory tracks the REAL per-query slot counts, and
    # the compressed scan indexes the resident LUT table directly (no
    # [W, TQ, M, 256] expansion). "dense" keeps the rectangular
    # [m, n_slots, k] tensor sized by the widest query (the comparison
    # baseline the parity suite and the skewed-memory bench run against).
    merge_layout: str = "segmented"


@dataclasses.dataclass
class EngineTask:
    """One routed (template × partition) product, in arena coordinates."""

    part: int  # arena partition id
    qrows: np.ndarray  # i64 — workload query rows routed here
    nprobe: int
    packed_bitmap: Optional[np.ndarray]  # bool, partition-packed order; None = all pass


@dataclasses.dataclass
class WorkUnit:
    """A (query-chunk × posting-list) pair, shaped (tq, padded list len)."""

    task: int  # index into ExecutionPlan.tasks (bitmap lookup at exec time)
    glist: int  # global posting-list id in the arena
    qrows: np.ndarray  # i64 [<=tq] — workload query rows
    slots: np.ndarray  # i64 [<=tq] — per-query output slot in the merge tensor


@dataclasses.dataclass
class ExecutionPlan:
    """The whole workload's vector work, bucketed for megabatched dispatch."""

    tasks: List[EngineTask]
    buckets: Dict[int, List[WorkUnit]]  # padded list len -> units (tq fixed)
    tq: int
    m: int  # workload queries
    k: int
    n_slots: int  # candidate slots per query in the DENSE merge tensor (max)
    # per-query REAL slot counts (seg_counts[q] slots were assigned to query
    # q; n_slots == seg_counts.max()): the segmented executor's CSR segment
    # widths, so its flat candidate buffer holds Σ seg_counts rows instead of
    # m·n_slots
    seg_counts: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.int64)
    )

    @property
    def n_units(self) -> int:
        return sum(len(u) for u in self.buckets.values())

    @property
    def n_dispatches(self) -> int:
        """Kernel dispatches stage 2 will issue — one per bucket."""
        return len(self.buckets)


def build_plan(
    arena: Optional[PackedArena],  # None allowed iff tasks is empty
    tasks: List[EngineTask],
    q_vecs: np.ndarray,  # f32 [m, d] — the workload's query vectors
    *,
    m: int,
    k: int,
    cfg: Optional[PlanConfig] = None,
    stats: Optional[ScanStats] = None,
) -> ExecutionPlan:
    """Route every task through its partition's quantizer and bucket globally.

    Each query receives one output *slot* per probed posting list (slot ids
    are dense per query, across all tasks); the executor scatters unit top-ks
    into a [m, n_slots, k] candidate tensor and reduces it in one device op.
    """
    cfg = PlanConfig() if cfg is None else cfg
    tq = cfg.tq_unit
    next_slot = np.zeros(m, dtype=np.int64)
    raw: Dict[int, List[WorkUnit]] = {}

    for t_id, task in enumerate(tasks):
        mt = len(task.qrows)
        if mt == 0:
            continue
        probes = arena.probe(task.part, q_vecs[task.qrows], task.nprobe)  # [mt, np_eff]
        np_eff = probes.shape[1]
        slot_base = next_slot[task.qrows].copy()
        next_slot[task.qrows] += np_eff

        # invert (query, probe-slot) -> per-list query groups
        flat_list = probes.reshape(-1).astype(np.int64)
        flat_q = np.repeat(np.arange(mt, dtype=np.int64), np_eff)
        flat_slot = np.tile(np.arange(np_eff, dtype=np.int64), mt)
        sort = np.argsort(flat_list, kind="stable")
        flat_list, flat_q, flat_slot = flat_list[sort], flat_q[sort], flat_slot[sort]
        uniq, group_starts = np.unique(flat_list, return_index=True)
        group_ends = np.append(group_starts[1:], len(flat_list))

        part_row0 = int(arena.part_row[task.part])
        for g, gs, ge in zip(uniq, group_starts, group_ends):
            llen = int(arena.list_len[g])
            if llen == 0:
                continue
            nq_group = int(ge - gs)
            if task.packed_bitmap is not None:
                s0 = int(arena.list_start[g]) - part_row0
                n_live = int(task.packed_bitmap[s0 : s0 + llen].sum())
            else:
                n_live = llen
            if stats is not None:
                stats.tuples_scanned += llen * nq_group
                stats.dists_computed += n_live * nq_group
            if n_live == 0:
                continue  # bitmap kills the whole list: scanned, no distances
            lp = _next_pow2(llen, cfg.min_list_pad)
            qs, slots = flat_q[gs:ge], flat_slot[gs:ge]
            for cs in range(0, nq_group, tq):
                raw.setdefault(lp, []).append(
                    WorkUnit(
                        task=t_id,
                        glist=int(g),
                        qrows=task.qrows[qs[cs : cs + tq]],
                        slots=slot_base[qs[cs : cs + tq]] + slots[cs : cs + tq],
                    )
                )

    buckets = _coalesce_shapes(raw, cfg.max_bucket_shapes)
    return ExecutionPlan(
        tasks=tasks,
        buckets=buckets,
        tq=tq,
        m=m,
        k=k,
        n_slots=int(next_slot.max()) if m else 0,
        seg_counts=next_slot,  # final per-query slot counts = segment widths
    )


@dataclasses.dataclass
class ShardedPlan:
    """The single-device plan, with every work unit routed to its owner rank.

    ``plan`` is the EXACT ``build_plan`` output a single device would execute
    — same probes, same buckets, same slot numbering, same compile-shape
    ladder — so sharded execution inherits its correctness structurally.
    ``rank_buckets[r]`` holds rank r's share of each bucket: a unit lands on
    the rank that stores its posting list, every unit lands on exactly one
    rank, and each shared pad executes as ONE sharded dispatch: one launch
    per device, over its ranks' units concatenated (``ops.sharded_*``).
    """

    plan: ExecutionPlan  # the workload's single-device plan, reused verbatim
    rank_buckets: List[Dict[int, List[WorkUnit]]]  # per rank: pad -> units

    @property
    def n_shards(self) -> int:
        return len(self.rank_buckets)

    @property
    def pads(self) -> List[int]:
        return sorted(self.plan.buckets)

    @property
    def per_rank_units(self) -> np.ndarray:
        return np.array(
            [sum(len(u) for u in rb.values()) for rb in self.rank_buckets],
            dtype=np.int64,
        )

    @property
    def n_units(self) -> int:
        return self.plan.n_units

    @property
    def n_dispatches(self) -> int:
        """Sharded kernel dispatches stage 2 will issue — one per shared pad."""
        return self.plan.n_dispatches


def build_plan_sharded(
    sharded: ShardedArena,
    tasks: List[EngineTask],
    q_vecs: np.ndarray,  # f32 [m, d]
    *,
    m: int,
    k: int,
    cfg: Optional[PlanConfig] = None,
    stats: Optional[ScanStats] = None,
) -> ShardedPlan:
    """Shard-aware stage 1: plan once, route work units to owner ranks.

    Probing, list grouping, query chunking, slot assignment, scan accounting,
    and shape coalescing all run through the single-device ``build_plan`` —
    sharding only PARTITIONS the resulting unit set by posting-list owner, so
    per-rank unit counts always sum to the single-device plan's (a property
    the hypothesis suite asserts) and the mesh shares one shape ladder.
    """
    plan = build_plan(sharded.base, tasks, q_vecs, m=m, k=k, cfg=cfg, stats=stats)
    R = sharded.n_shards
    rank_buckets: List[Dict[int, List[WorkUnit]]] = [{} for _ in range(R)]
    for lp, units in plan.buckets.items():
        owners = sharded.owner_of_list(
            np.array([u.glist for u in units], dtype=np.int64)
        )
        for u, r in zip(units, owners):
            rank_buckets[int(r)].setdefault(lp, []).append(u)
    return ShardedPlan(plan=plan, rank_buckets=rank_buckets)


def _coalesce_shapes(
    raw: Dict[int, List[WorkUnit]], max_shapes: int
) -> Dict[int, List[WorkUnit]]:
    """Enforce the compile-shape budget by rounding small pads up.

    Keeps the ``max_shapes`` largest padded lengths (the largest can never
    shrink) and folds every smaller bucket into the smallest survivor —
    correctness is unaffected because padding rows are masked invalid.
    """
    if max_shapes <= 0 or len(raw) <= max_shapes:
        return raw
    pads = sorted(raw)
    kept = pads[-max_shapes:]
    out: Dict[int, List[WorkUnit]] = {p: list(raw[p]) for p in kept}
    for p in pads[: -max_shapes]:
        out[kept[0]].extend(raw[p])
    return out
