"""Hybrid-query baselines — Strategies A–D of Section 2.2.

  * Exhaustive (A): bitmap + full scan; produces the ground truth.
  * PreFilter (B): one IVF over V + bitmap pushdown; per-query scans with
    attribute-constraint batching (bitmaps amortized per template), or with
    ``batch_vec=True`` one global plan through the engine.
  * Range (C): range partitioning on one numeric attribute + per-partition
    IVF; NA for workloads whose constraints are not ranges (Table 3).
  * PostFilter (D): IVF search first (expanded k'), attribute filter after.

All share HQI's IVF implementation, so a comparison isolates the paper's
layout and batching, not kernel quality. Index building (k-means) and
probing run on ``device`` (default "cuda"); the per-query scans are host
numpy, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..kernels import ops as kops
from . import kmeans as km
from .arena import PackedArena
from .ivf import IVFIndex, ScanStats
from .plan import EngineTask, PlanConfig, build_plan
from .planner import execute_plan
from .predicates import Between, Cmp, evaluate_filter
from .types import SearchResult, VectorDatabase, Workload

# score-matrix elements per chunk: 2^28 f32 = 1 GiB on the device
_CHUNK_ELEMENTS = 1 << 28


def exhaustive_search(
    db: VectorDatabase,
    workload: Workload,
    *,
    chunk: Optional[int] = None,
    device: Optional[km.Device] = None,
) -> SearchResult:
    """Exact hybrid search: bitmap per template + full masked scan with the
    plain masked top-k (no kernel: this is the oracle), on ``device``
    (default "cuda"). Queries go in chunks of ``chunk`` rows, by default as
    many as keep one chunk's score matrix within 1 GiB."""
    device = torch.device("cuda" if device is None else device)
    m, k = workload.m, workload.k
    if chunk is None:
        chunk = max(1, min(4096, _CHUNK_ELEMENTS // max(db.n, 1)))
    out_s = np.full((m, k), -np.inf, np.float32)
    out_i = np.full((m, k), -1, np.int64)
    scanned = 0
    v = km.as_tensor(db.vectors, device)
    for ti, filt in enumerate(workload.templates):
        qidx = workload.queries_for_template(ti)
        if len(qidx) == 0:
            continue
        bitmap = evaluate_filter(filt, db)
        scanned += db.n * len(qidx)
        valid = torch.from_numpy(bitmap).to(device)
        for s in range(0, len(qidx), chunk):
            qs = qidx[s : s + chunk]
            sc, ix = kops.masked_topk(
                km.as_tensor(workload.vectors[qs], device), v, valid, k, metric=db.metric
            )
            out_s[qs] = sc.cpu().numpy()
            out_i[qs] = ix.cpu().numpy().astype(np.int64)
    return SearchResult(ids=out_i, scores=out_s, tuples_scanned=scanned)


# ---------------------------------------------------------------------------
# Strategy B — PreFilter (attribute filter → IVF with bitmap pushdown)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PreFilterIndex:
    db: VectorDatabase
    ivf: IVFIndex
    build_seconds: float = 0.0

    @staticmethod
    def build(
        db: VectorDatabase,
        *,
        n_centroids: Optional[int] = None,
        kmeans_iters: int = 8,
        seed: int = 0,
        device: km.Device = "cuda",
    ) -> "PreFilterIndex":
        t0 = time.perf_counter()
        ivf = IVFIndex.build(
            db.vectors, metric=db.metric, n_centroids=n_centroids,
            kmeans_iters=kmeans_iters, seed=seed, device=device,
        )
        return PreFilterIndex(db=db, ivf=ivf, build_seconds=time.perf_counter() - t0)

    def search(
        self,
        workload: Workload,
        *,
        nprobe: Union[int, Dict[int, int]] = 8,
        batch_attr: bool = True,
        batch_vec: bool = False,
        plan: Optional[PlanConfig] = None,
    ) -> SearchResult:
        """batch_attr: amortize bitmaps per template (on for all baselines,
        as in the paper). batch_vec: Alg.-3 style vector batching through the
        plan/execute engine — off for the PreFilter baseline, on gives the
        "batching on a vanilla IVF" ablation of Sections 6.3/6.5."""
        plan = PlanConfig() if plan is None else plan
        m, k = workload.m, workload.k
        out_s = np.full((m, k), -np.inf, np.float32)
        out_i = np.full((m, k), -1, np.int64)
        stats = ScanStats()
        bitmap_cache: Dict[int, np.ndarray] = {}
        if batch_attr:
            order = [(ti, workload.queries_for_template(ti)) for ti in range(len(workload.templates))]
        else:
            order = [(int(workload.template_of[qi]), np.array([qi])) for qi in range(m)]
        arena = PackedArena.from_ivf(self.ivf) if batch_vec else None
        tasks = []
        for ti, qidx in order:
            if len(qidx) == 0:
                continue
            if batch_attr and ti in bitmap_cache:
                bitmap = bitmap_cache[ti]
            else:
                bitmap = evaluate_filter(workload.templates[ti], self.db)
                if batch_attr:
                    bitmap_cache[ti] = bitmap
            np_t = nprobe[ti] if isinstance(nprobe, dict) else nprobe
            if batch_vec:
                # all-false bitmaps still become tasks: build_plan accounts the
                # scanned (bitmap-killed) lists exactly like search_single does
                packed = None if bitmap.all() else arena.packed_bitmap(0, bitmap)
                tasks.append(
                    EngineTask(
                        part=0,
                        qrows=qidx.astype(np.int64),
                        nprobe=int(min(np_t, self.ivf.n_lists)),
                        packed_bitmap=packed,
                    )
                )
            else:
                for qi in qidx:
                    s, ix = self.ivf.search_single(
                        workload.vectors[qi], nprobe=np_t, k=k, bitmap=bitmap, stats=stats
                    )
                    out_s[qi], out_i[qi] = s, ix
        if batch_vec:
            # one global plan across ALL templates: one dispatch per bucket shape
            eplan = build_plan(arena, tasks, workload.vectors, m=m, k=k, cfg=plan, stats=stats)
            out_s, out_i = execute_plan(eplan, arena, workload.vectors, cfg=plan)
        return SearchResult(ids=out_i, scores=out_s, tuples_scanned=stats.tuples_scanned)


# ---------------------------------------------------------------------------
# Strategy D — PostFilter (ANN first, filter after)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PostFilterIndex:
    db: VectorDatabase
    ivf: IVFIndex
    build_seconds: float = 0.0

    @staticmethod
    def build(
        db: VectorDatabase,
        *,
        n_centroids: Optional[int] = None,
        kmeans_iters: int = 8,
        seed: int = 0,
        device: km.Device = "cuda",
    ) -> "PostFilterIndex":
        t0 = time.perf_counter()
        ivf = IVFIndex.build(
            db.vectors, metric=db.metric, n_centroids=n_centroids,
            kmeans_iters=kmeans_iters, seed=seed, device=device,
        )
        return PostFilterIndex(db=db, ivf=ivf, build_seconds=time.perf_counter() - t0)

    def search(
        self,
        workload: Workload,
        *,
        nprobe: Union[int, Dict[int, int]] = 8,
        expansion: int = 10,  # k' = expansion * k candidates before filtering
    ) -> SearchResult:
        m, k = workload.m, workload.k
        out_s = np.full((m, k), -np.inf, np.float32)
        out_i = np.full((m, k), -1, np.int64)
        stats = ScanStats()
        kprime = min(expansion * k, self.db.n)
        for ti, filt in enumerate(workload.templates):
            qidx = workload.queries_for_template(ti)
            if len(qidx) == 0:
                continue
            bitmap = evaluate_filter(filt, self.db)
            np_t = nprobe[ti] if isinstance(nprobe, dict) else nprobe
            for qi in qidx:
                s, ix = self.ivf.search_single(
                    workload.vectors[qi], nprobe=np_t, k=kprime, bitmap=None, stats=stats
                )
                ok = (ix >= 0) & bitmap[np.maximum(ix, 0)]
                s, ix = s[ok][:k], ix[ok][:k]
                out_s[qi, : len(s)] = s
                out_i[qi, : len(ix)] = ix
        return SearchResult(ids=out_i, scores=out_s, tuples_scanned=stats.tuples_scanned)


# ---------------------------------------------------------------------------
# Strategy C — Range partitioning on one attribute
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RangeIndex:
    db: VectorDatabase
    attr: str
    bounds: np.ndarray  # [nb + 1] bucket edges over the partitioning attribute
    partitions: List[Tuple[np.ndarray, IVFIndex]]  # (rows, ivf)
    build_seconds: float = 0.0

    @staticmethod
    def build(
        db: VectorDatabase,
        attr: str,
        *,
        n_buckets: int = 16,
        kmeans_iters: int = 8,
        seed: int = 0,
        device: km.Device = "cuda",
    ) -> "RangeIndex":
        t0 = time.perf_counter()
        col = db.columns[attr]
        vals = col.values.astype(np.float64)
        qs = np.linspace(0, 1, n_buckets + 1)
        bounds = np.quantile(vals[~col.null_mask], qs)  # equi-depth
        bounds[0], bounds[-1] = -np.inf, np.inf
        which = np.clip(np.searchsorted(bounds, vals, side="right") - 1, 0, n_buckets - 1)
        parts = []
        for b in range(n_buckets):
            rows = np.nonzero(which == b)[0]
            if len(rows) == 0:
                continue
            ivf = IVFIndex.build(
                db.vectors[rows],
                metric=db.metric,
                n_centroids=max(1, int(math.isqrt(len(rows)))),
                kmeans_iters=kmeans_iters,
                seed=seed,
                device=device,
            )
            parts.append((rows, ivf))
        return RangeIndex(
            db=db, attr=attr, bounds=bounds, partitions=parts,
            build_seconds=time.perf_counter() - t0,
        )

    @staticmethod
    def applicable(workload: Workload) -> bool:
        """Range requires numeric range/comparison predicates (Table 3: NA for
        RelatedQS/LP whose constraints are IN / IS NOT NULL over many attrs)."""
        for t in workload.templates:
            for p in t:
                if not isinstance(p, (Between, Cmp)):
                    return False
        return True

    def _bucket_range(self, filt) -> Tuple[float, float]:
        lo, hi = -np.inf, np.inf
        for p in filt:
            if isinstance(p, Between) and p.attr == self.attr:
                lo, hi = max(lo, p.lo), min(hi, p.hi)
            elif isinstance(p, Cmp) and p.attr == self.attr:
                if p.op in (">", ">="):
                    lo = max(lo, p.value)
                elif p.op in ("<", "<="):
                    hi = min(hi, p.value)
                elif p.op == "==":
                    lo, hi = max(lo, p.value), min(hi, p.value)
        return lo, hi

    def search(
        self,
        workload: Workload,
        *,
        nprobe: Union[int, Dict[int, int]] = 8,
    ) -> SearchResult:
        m, k = workload.m, workload.k
        out_s = np.full((m, k), -np.inf, np.float32)
        out_i = np.full((m, k), -1, np.int64)
        stats = ScanStats()
        for ti, filt in enumerate(workload.templates):
            qidx = workload.queries_for_template(ti)
            if len(qidx) == 0:
                continue
            bitmap = evaluate_filter(filt, self.db)
            lo, hi = self._bucket_range(filt)
            np_t = nprobe[ti] if isinstance(nprobe, dict) else nprobe
            for rows, ivf in self.partitions:
                vals = self.db.columns[self.attr].values[rows]
                # prune bucket iff its value range is disjoint from [lo, hi)
                bmin, bmax = float(vals.min()), float(vals.max())
                if bmax < lo or bmin >= hi:
                    continue
                local_bitmap = bitmap[rows]
                if not local_bitmap.any():
                    continue
                for qi in qidx:
                    s, loc = ivf.search_single(
                        workload.vectors[qi], nprobe=np_t, k=k, bitmap=local_bitmap, stats=stats
                    )
                    gid = np.where(loc >= 0, rows[np.maximum(loc, 0)], -1)
                    cat_s = np.concatenate([out_s[qi], s])
                    cat_i = np.concatenate([out_i[qi], gid])
                    top = np.argsort(-cat_s, kind="stable")[:k]
                    out_s[qi], out_i[qi] = cat_s[top], cat_i[top]
        return SearchResult(ids=out_i, scores=out_s, tuples_scanned=stats.tuples_scanned)
