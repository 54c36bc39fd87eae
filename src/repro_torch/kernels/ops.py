"""Dispatch layer of the kernels package: what the engine calls.

``workunit_topk`` is the engine's f32 scan entry point; it picks one of the
two ``fused_knn`` grids. ``workunit_pq_topk`` (expanded LUTs) and
``workunit_pq_topk_resident`` (the resident LUT table) are the compressed
scan's, over the ADC kernel of ``pq_scan``. Each runs its CUDA kernel on a
CUDA tensor and its plain version on a CPU tensor: the device decides, there
is no backend switch. The merges, ``pairwise_scores`` and ``masked_topk``
are plain PyTorch on the tensors' device, as the reference leaves them to
XLA.

The ``sharded_*`` wrappers are the reference's ``shard_map`` dispatches over
a device mesh (``launch/mesh.py``), single-controller as it is: one process
holds every rank's operands, each on its rank's device. A scan wrapper calls
the single-device kernel once per distinct device, over that device's ranks'
units concatenated along W; units are independent, so the stacking changes
no result, and ranks that share a card make one launch per bucket. The only
cross-rank step is ``sharded_merge_topk``'s gather of per-query top-k
candidates to the first rank's device.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, List, Optional, Sequence

import torch

from . import ref as _ref
from .fused_knn import fused_knn, fused_knn_db_stationary
from .pq_scan import workunit_pq_scan, workunit_pq_scan_streamed

# TV/TQ ratio from which a work-unit bucket takes the split-V (db-stationary)
# grid: the one place the kernel choice lives
DB_STATIONARY_RATIO = 4


@dataclasses.dataclass
class DispatchStats:
    """Process-wide kernel-dispatch accounting (see core/planner.py).

    ``knn_calls`` counts scan dispatches (one per shape bucket, plus the
    compressed path's re-rank); ``merge_calls`` counts top-k merges.
    ``shapes`` holds the distinct problem shapes seen: (W, TQ, TV, k) for
    the f32 scan, ("pq", W, TQ, TV, k) and ("pq-res", W, TQ, TV, k) for the
    two ADC dispatches. ``peak_candidate_bytes`` is the largest candidate
    merge buffer any single execution materialized (scores + ids).
    ``lut_expand_bytes`` accumulates the bytes of every expanded per-unit
    [W, TQ, M, 256] ADC LUT operand (the dense layout's); the resident-table
    dispatch never records here, so a zero delta across a compressed search
    shows that no LUT was expanded.

    Thread-safe: all mutation goes through a lock; read a consistent copy
    with ``snapshot()``.
    """

    knn_calls: int = 0
    merge_calls: int = 0
    shapes: set = dataclasses.field(default_factory=set)
    peak_candidate_bytes: int = 0
    lut_expand_bytes: int = 0
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False
    )

    def record_knn(self, shape: tuple) -> None:
        with self._lock:
            self.knn_calls += 1
            self.shapes.add(shape)
        hook = _PROFILE_HOOK
        if hook is not None:
            hook("knn", shape)

    def record_merge(self) -> None:
        with self._lock:
            self.merge_calls += 1
        hook = _PROFILE_HOOK
        if hook is not None:
            hook("merge", None)

    def record_candidate_bytes(self, nbytes: int) -> None:
        with self._lock:
            self.peak_candidate_bytes = max(self.peak_candidate_bytes, int(nbytes))

    def record_lut_expand(self, nbytes: int) -> None:
        with self._lock:
            self.lut_expand_bytes += int(nbytes)

    def reset(self) -> None:
        with self._lock:
            self.knn_calls = 0
            self.merge_calls = 0
            self.shapes = set()
            self.peak_candidate_bytes = 0
            self.lut_expand_bytes = 0

    def snapshot(self) -> "DispatchStats":
        """Consistent point-in-time copy (counters + shape set)."""
        with self._lock:
            return DispatchStats(
                knn_calls=self.knn_calls,
                merge_calls=self.merge_calls,
                shapes=set(self.shapes),
                peak_candidate_bytes=self.peak_candidate_bytes,
                lut_expand_bytes=self.lut_expand_bytes,
            )

    def delta_since(self, prev: "DispatchStats") -> "DispatchStats":
        """What happened between two snapshots: ``after.delta_since(before)``.

        Running counters subtract; ``shapes`` is the set of shapes first seen
        in the interval; ``peak_candidate_bytes`` is a lifetime high-water
        mark, not a rate, so the delta carries the current value unchanged.
        """
        a, b = self.snapshot(), prev
        return DispatchStats(
            knn_calls=a.knn_calls - b.knn_calls,
            merge_calls=a.merge_calls - b.merge_calls,
            shapes=a.shapes - b.shapes,
            peak_candidate_bytes=a.peak_candidate_bytes,
            lut_expand_bytes=a.lut_expand_bytes - b.lut_expand_bytes,
        )


_DISPATCH = DispatchStats()


def dispatch_stats() -> DispatchStats:
    return _DISPATCH


def reset_dispatch_stats() -> None:
    _DISPATCH.reset()


# Issue-level profiler hook (obs.profile): called as hook(kind, shape) on
# every kernel dispatch and merge — "knn" with the problem shape, "merge"
# with None — so the profiler can report attribution *coverage* (a dispatch
# its plan-level sites did not attribute shows up as issued-but-unattributed).
# One global load when disarmed; obs imports stay lazy from this side.
_PROFILE_HOOK = None


def set_profile_hook(cb) -> None:
    global _PROFILE_HOOK
    _PROFILE_HOOK = cb


def pairwise_scores(q: torch.Tensor, v: torch.Tensor, metric: str = "ip") -> torch.Tensor:
    """Dense score matrix (no masking/top-k): a plain product."""
    return _ref.pairwise_scores_ref(q, v, metric)


def masked_topk(
    q: torch.Tensor, v: torch.Tensor, valid: torch.Tensor, k: int, *, metric: str = "ip"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked similarity top-k of one query block against one vector set,
    plain PyTorch (the exhaustive oracle's scan)."""
    return _ref.masked_topk_ref(q, v, valid, int(k), metric)


def use_db_stationary(tq: int, tv: int) -> bool:
    """The split-V grid serves buckets whose rows dominate their queries."""
    return tv >= DB_STATIONARY_RATIO * max(int(tq), 1)


def workunit_topk(
    q: torch.Tensor,  # [W, TQ, D]  one bucket's work units (see core/plan.py)
    v: torch.Tensor,  # [W, TV, D]
    valid: torch.Tensor,  # bool [W, TV]
    k: int,
    *,
    metric: str = "ip",
    n_live: torch.Tensor | None = None,  # i32 [W]: real query slots per unit (None: all)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Work-unit entry point of the execution engine: one bucket, one dispatch.

    Picks the split-V grid when the vector tile dominates the query tile
    (``use_db_stationary``), the query-stationary grid otherwise. Slot s of
    unit w holds a query iff s < ``n_live[w]``; the others are
    ``(NEG_INF, -1)`` and are never scored.
    """
    _DISPATCH.record_knn((q.shape[0], q.shape[1], v.shape[1], int(k)))
    return _unit_scan(q, v, valid, k, metric, n_live)


def _unit_scan(q, v, valid, k: int, metric: str, n_live):
    """``workunit_topk``'s grid choice and launch, unrecorded (the sharded
    wrapper records its own dispatch)."""
    fn = fused_knn_db_stationary if use_db_stationary(q.shape[1], v.shape[1]) else fused_knn
    return fn(q, v, valid, k=int(k), metric=metric, n_live=n_live)


def workunit_pq_topk(
    luts: torch.Tensor,  # f32 [W, TQ, M, 256] — per-query ADC tables per unit
    codes: torch.Tensor,  # uint8 [W, TV, M] — gathered PQ code rows per unit
    valid: torch.Tensor,  # bool [W, TV]
    k: int,
    *,
    n_live: torch.Tensor | None = None,  # i32 [W]: real query slots per unit (None: all)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Compressed (ADC) work-unit entry point over expanded LUTs: one bucket
    of the dense layout's scan stage, one ``workunit_pq_scan`` dispatch.
    Codes stay uint8 across the dispatch boundary. Slot s of unit w holds a
    query iff s < ``n_live[w]``; the others are ``(NEG_INF, -1)`` and their
    LUTs are never read."""
    _DISPATCH.record_knn(("pq", luts.shape[0], luts.shape[1], codes.shape[1], int(k)))
    return workunit_pq_scan(luts, codes, valid, k=int(k), n_live=n_live)


def workunit_pq_topk_resident(
    table: torch.Tensor,  # f32 [U, M, 256] — the workload's resident ADC tables
    lut_idx: torch.Tensor,  # i32 [W, TQ] — per-slot row into ``table`` (-1: no query)
    codes: torch.Tensor,  # uint8 [W, TV, M]
    valid: torch.Tensor,  # bool [W, TV]
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Compressed work-unit dispatch indexing the resident LUT table: the
    kernel reads each slot's row from ``table`` (``workunit_pq_scan_streamed``),
    so no [W, TQ, M, 256] operand exists. Equal to ``workunit_pq_topk`` over
    ``table[lut_idx]``, bit for bit, on every slot of index >= 0; a slot of
    index -1 holds no query and gives ``(NEG_INF, -1)``."""
    _DISPATCH.record_knn(("pq-res", lut_idx.shape[0], lut_idx.shape[1], codes.shape[1], int(k)))
    return workunit_pq_scan_streamed(table, lut_idx, codes, valid, k=int(k))


def merge_topk(
    scores: torch.Tensor,  # f32 [m, C] — per-query candidate scores (-inf = absent)
    idx: torch.Tensor,  # i64 [m, C] — candidate ids (-1 = absent)
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-query top-k over candidate rows (stable: ties keep column order)."""
    _DISPATCH.record_merge()
    return _ref.normalize_merge_sentinels(*_stable_topk(scores, idx, k))


def _stable_topk(scores: torch.Tensor, idx: torch.Tensor, k: int):
    """Top-k along the last dim by (score desc, position asc): ``lax.top_k``'s
    tie rule, which ``torch.topk`` does not promise."""
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.gather(scores, -1, order), torch.gather(idx, -1, order)


def segmented_merge_topk(
    flat_s: torch.Tensor,  # f32 [C, kk] — flat candidate rows (CSR layout)
    flat_i: torch.Tensor,  # i64 [C, kk] — candidate ids (-1 = absent)
    seg_of: torch.Tensor,  # i32 [C] — owning query per row, ascending; >= n_segments = pad
    n_segments: int,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Ragged per-query top-k reduction — the segmented ``merge_topk``;
    bit-identical to the dense merge over the same per-segment candidate
    order (``ref.segmented_merge_topk_ref``)."""
    _DISPATCH.record_merge()
    return _ref.segmented_merge_topk_ref(flat_s, flat_i, seg_of, int(n_segments), int(k))


# --------------------------------------------------------------------------
# Sharded dispatch (device-mesh execution, see core/planner.py's sharded path)
#
# Operands are sequences over the mesh axis's ranks: rank r's tensors on its
# device, or None where rank r has no units in the bucket (the reference's
# fully-masked zero slice, which launches nothing here). Rank r's W is its
# own unit count; the dispatch is recorded at the reference's stacked shape,
# W the power of two at or above the largest rank's.


def _n_ranks(mesh, axis: str, per_rank: Sequence) -> int:
    R = int(mesh.shape[axis])
    if len(per_rank) != R:
        raise ValueError(f"{len(per_rank)} ranks' operands for mesh axis {axis!r} of {R}")
    return R


def _per_device(call: Callable, per_rank: Sequence[Optional[tuple]]) -> List[Optional[tuple]]:
    """``call(device, *operands)`` once per distinct device, over its ranks'
    operands concatenated along dim 0 (an operand that is None for every
    rank stays None); the results are split back per rank, None where a
    rank had no operands."""
    groups: dict = {}
    for r, ops_r in enumerate(per_rank):
        if ops_r is not None:
            groups.setdefault(ops_r[0].device, []).append(r)
    out: List[Optional[tuple]] = [None] * len(per_rank)
    for dev, ranks in groups.items():
        parts = [per_rank[r] for r in ranks]
        cat = [
            None if parts[0][j] is None
            else parts[0][j] if len(parts) == 1
            else torch.cat([p[j] for p in parts])
            for j in range(len(parts[0]))
        ]
        res = call(dev, *cat)
        sizes = [p[0].shape[0] for p in parts]
        splits = [torch.split(t, sizes) for t in res]
        for g, r in enumerate(ranks):
            out[r] = tuple(sp[g] for sp in splits)
    return out


def _stacked_shape(tensors: Sequence[Optional[torch.Tensor]]) -> tuple:
    """The reference's stacked per-rank shape of a sharded operand: W the
    power of two at or above the largest rank's unit count, the rest as
    every rank's."""
    live = [t for t in tensors if t is not None]
    if not live or any(t.shape[1:] != live[0].shape[1:] for t in live):
        raise ValueError(f"ranks' operands differ in shape: {[tuple(t.shape) for t in live]}")
    W = 1 << (max(t.shape[0] for t in live) - 1).bit_length()
    return (W,) + tuple(live[0].shape[1:])


def sharded_workunit_topk(
    mesh,
    axis: str,
    q: Sequence[Optional[torch.Tensor]],  # per rank: f32 [W_r, TQ, D] on its device
    v: Sequence[Optional[torch.Tensor]],  # per rank: f32 [W_r, TV, D]
    valid: Sequence[Optional[torch.Tensor]],  # per rank: bool [W_r, TV]
    k: int,
    *,
    metric: str = "ip",
    n_live: Optional[Sequence[Optional[torch.Tensor]]] = None,  # per rank: i32 [W_r]
) -> List[Optional[tuple]]:
    """``workunit_topk`` across the mesh: one dispatch, every rank its units.

    Returns rank r's (scores f32 [W_r, TQ, kk], idx i32 [W_r, TQ, kk]) on its
    device, None for a rank without units. Other mesh axes (data, pod)
    replicate, as in the reference.
    """
    R = _n_ranks(mesh, axis, q)
    W, TQ, _ = _stacked_shape(q)
    TV = _stacked_shape(v)[1]
    _DISPATCH.record_knn(("sh", R, W, TQ, TV, int(k)))
    lives = [None] * R if n_live is None else n_live
    per_rank = [None if q[r] is None else (q[r], v[r], valid[r], lives[r]) for r in range(R)]
    return _per_device(
        lambda dev, q_, v_, valid_, live_: _unit_scan(q_, v_, valid_, k, metric, live_), per_rank
    )


def sharded_workunit_pq_topk(
    mesh,
    axis: str,
    luts: Sequence[torch.Tensor],  # per rank: f32 [U, M, 256], the resident table on its device
    lut_idx: Sequence[Optional[torch.Tensor]],  # per rank: i32 [W_r, TQ] (-1: no query)
    codes: Sequence[Optional[torch.Tensor]],  # per rank: uint8 [W_r, TV, M]
    valid: Sequence[Optional[torch.Tensor]],  # per rank: bool [W_r, TV]
    k: int,
    *,
    stream: bool = False,
    n_live: Optional[Sequence[Optional[torch.Tensor]]] = None,  # per rank: i32 [W_r]
) -> List[Optional[tuple]]:
    """Compressed (ADC) sharded scan — ``workunit_pq_topk`` across the mesh.

    The workload's ADC table is replicated: one copy per device. With
    ``stream=True`` (the segmented layout) each device's call reads the
    resident table through ``lut_idx`` (``workunit_pq_scan_streamed``), so
    no expanded operand exists; with ``stream=False`` (the dense layout) each
    device expands its units' [W, TQ, M, 256] LUTs and runs
    ``workunit_pq_scan`` with ``n_live``.
    """
    R = _n_ranks(mesh, axis, codes)
    W, TQ = _stacked_shape(lut_idx)
    TV = _stacked_shape(codes)[1]
    _DISPATCH.record_knn(("sh-pq", R, W, TQ, TV, int(k)))
    table = {}
    for r in range(R):
        if codes[r] is not None:
            table.setdefault(codes[r].device, luts[r])

    def call(dev, idx, codes_, valid_, live_):
        tab = table[dev]
        if stream:
            return workunit_pq_scan_streamed(tab, idx, codes_, valid_, k=int(k))
        per_unit = tab.index_select(0, idx.clamp(min=0).reshape(-1)).reshape(
            idx.shape + tab.shape[1:])
        return workunit_pq_scan(per_unit, codes_, valid_, k=int(k), n_live=live_)

    lives = [None] * R if n_live is None else n_live
    per_rank = [None if codes[r] is None else (lut_idx[r], codes[r], valid[r], lives[r])
                for r in range(R)]
    return _per_device(call, per_rank)


def sharded_merge_topk(
    mesh,
    axis: str,
    scores: Sequence[torch.Tensor],  # per rank: f32 [m, C] on its device
    idx: Sequence[torch.Tensor],  # per rank: i64 [m, C] GLOBAL candidate ids (-1 = absent)
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The engine's only cross-rank step: per-query top-k candidate gather.

    Each rank first reduces its own C candidate columns to its local top-k
    by (score desc, index asc) and normalizes the sentinels; the gather moves
    every rank's [m, k] survivors to the first rank's device, rank-major
    (k·|model| candidates per query, independent of DB size), and a final
    top-k under the same rule selects the result: the smallest position in
    that concatenation wins a tie, as ``lax.top_k`` does.
    """
    _DISPATCH.record_merge()
    _n_ranks(mesh, axis, scores)
    dev0 = mesh.axis_devices(axis)[0]
    m = scores[0].shape[0]
    gathered_s, gathered_i = [], []
    for s, i in zip(scores, idx):
        top, li = _ref.normalize_merge_sentinels(*_stable_topk(s, i, k))
        gathered_s.append(top.to(dev0))
        gathered_i.append(li.to(dev0))
    cat_s = torch.stack(gathered_s, dim=1).reshape(m, -1)  # [m, R·k], rank-major
    cat_i = torch.stack(gathered_i, dim=1).reshape(m, -1)
    return _ref.normalize_merge_sentinels(*_stable_topk(cat_s, cat_i, k))
