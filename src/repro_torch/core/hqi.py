"""HQI — the paper's hybrid query index (Sections 4 + 5, end to end).

Build:  coarse k-means (m > 0 mode) → balanced qd-tree over attribute +
centroid cut predicates → one IVF index per leaf partition (√|Pᵢ| lists) →
one index-wide ``PackedArena`` concatenating every partition's posting lists.

Batch search (Algorithm 3 across partitions) is a two-stage plan/execute
engine over the whole workload:

  * ``Router`` (the routing layer): template → partition routes via semantic
    descriptions, per-query centroid gating when m > 0, and the template
    bitmap cache — all the host-side pruning of Sections 4.1.3 / 4.2.
  * Stage 1 (core/plan.py): every routed (template × partition) product
    becomes an ``EngineTask``; ``build_plan`` buckets ALL resulting
    (query-chunk × posting-list) work units globally by padded shape, under
    the ``PlanConfig.max_bucket_shapes`` compile-shape budget.
  * Stage 2 (core/planner.py): each bucket executes as ONE megabatched
    kernel dispatch through the arena, and the cross-partition merge is one
    device-side segmented top-k.

Kernel dispatches per workload are therefore O(#buckets) ≤
``max_bucket_shapes`` instead of O(templates × partitions).

Compressed execution (``scan_mode="pq"``): ``build`` also trains an
index-wide PQ codebook, the arena carries uint8 codes, and the engine runs
an ADC scan over them followed by an exact f32 re-rank (core/planner.py).

Device: k-means, probing, the arena and the engine run on the index's
``device`` ("cuda" unless the caller passes another, as the CPU tests pass
"cpu"); the qd-tree, routing and plan are host numpy. Not ported yet: the
sharded engine (``mesh``, ROADMAP.md §1, sharded engine). ``extend``
folds new rows into the existing partitions (the online service's
``refresh()``).

Online search: same routing, per-query IVF scans (used standalone — the
"workload-aware index only" configuration of Section 6.5). The "auto" mode
is the paper's adaptive executor: small (template × partition) groups take
the per-query path, everything else joins the global plan, and both feed the
same final merge.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

import torch

from ..obs.trace import get_tracer
from . import kmeans as km
from .arena import PackedArena
from .ivf import IVFIndex, ScanStats
from .plan import EngineTask, PlanConfig, build_plan
from .planner import ExtraCandidates, execute_plan
from .pq import PQCodebook, train_pq
from .predicates import evaluate_filter, filter_from_state, filter_to_state
from .qdtree import QDTree, build_qdtree
from .types import SearchResult, VectorDatabase, Workload


MESH_NOT_PORTED = (
    "sharded execution (HQIConfig.mesh) is not ported yet: ROADMAP.md §1, sharded engine"
)


@dataclasses.dataclass
class HQIConfig:
    m: int = 0  # query-to-centroid fan-out of Section 4.1.1 (0 = attrs only)
    n_coarse_centroids: int = 64  # coarse clustering for partitioning (m > 0)
    min_partition_size: int = 4096
    max_leaves: int = 1024
    ivf_centroids: Optional[int] = None  # default sqrt(|Pi|)
    kmeans_iters: int = 8
    cost_mode: str = "tuples"
    seed: int = 0
    plan: PlanConfig = dataclasses.field(default_factory=PlanConfig)
    # compressed execution (engine knobs, mirrored into ``plan`` when set):
    # scan_mode="pq" trains an index-wide PQ codebook at build time, stores
    # uint8 codes in the arena, and runs the ADC scan -> exact re-rank path
    scan_mode: Optional[str] = None  # None = keep plan.scan_mode
    refine_factor: Optional[int] = None  # None = keep plan.refine_factor
    pq_m: int = 8  # PQ subspaces (d must be divisible; d·4/M× compression)
    # sharded execution: not ported yet (ROADMAP.md §1, sharded engine);
    # anything but None raises at build and load
    mesh: Optional[object] = None
    shard_spec: Optional[object] = None

    def __post_init__(self):
        # replace, never mutate: the caller may share one PlanConfig across
        # HQIConfigs, and flipping its scan_mode in place would silently
        # switch sibling indexes onto a path they have no codebook for
        if self.scan_mode is not None:
            self.plan = dataclasses.replace(self.plan, scan_mode=self.scan_mode)
        if self.refine_factor is not None:
            self.plan = dataclasses.replace(
                self.plan, refine_factor=int(self.refine_factor)
            )

    def to_state(self) -> dict:
        """Snapshot state (store/snapshot.py). ``mesh``/``shard_spec`` are
        runtime wiring (device handles), not index state — a loaded index
        re-attaches them explicitly."""
        state = {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if f.name not in ("plan", "mesh", "shard_spec")
        }
        state["plan"] = dataclasses.asdict(self.plan)
        return state

    @staticmethod
    def from_state(state: dict) -> "HQIConfig":
        kw = dict(state)
        kw["plan"] = PlanConfig(**kw["plan"])
        return HQIConfig(**kw)


@dataclasses.dataclass
class Partition:
    rows: np.ndarray  # global tuple indices, aligned with ivf local order
    ivf: IVFIndex


@dataclasses.dataclass
class BuildInfo:
    qdtree_seconds: float = 0.0
    ivf_seconds: float = 0.0
    coarse_seconds: float = 0.0
    pq_seconds: float = 0.0  # codebook training (scan_mode="pq" only)

    @property
    def total_seconds(self) -> float:
        return (
            self.qdtree_seconds + self.ivf_seconds + self.coarse_seconds
            + self.pq_seconds
        )


class Router:
    """The routing layer: which (template, query) reaches which partition.

    Owns the qd-tree semantic-description routing (Section 4.1.3), the
    per-query centroid gating of the m > 0 mode, and the template bitmap
    cache (Section 4.2) — everything the engine needs to turn a workload
    into ``EngineTask``s.
    """

    def __init__(
        self,
        db: VectorDatabase,
        tree: QDTree,
        coarse_centroids: Optional[np.ndarray],
        m_fanout: int,
        device: km.Device = "cuda",
    ):
        self.db = db
        self.tree = tree
        self.coarse_centroids = coarse_centroids
        self.m_fanout = m_fanout
        self.device = device
        self._bitmap_cache: Dict[tuple, np.ndarray] = {}

    def template_bitmap(self, filt: tuple) -> np.ndarray:
        if filt not in self._bitmap_cache:
            self._bitmap_cache[filt] = evaluate_filter(filt, self.db)
        return self._bitmap_cache[filt]

    def clear_cache(self) -> None:
        self._bitmap_cache.clear()

    def routes(self, workload: Workload) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """(template_routes bool [T, L], query_centroid_ok bool [m, L] | None)."""
        troutes = np.stack([self.tree.route_filter(t) for t in workload.templates])
        qcent_ok = None
        if self.m_fanout > 0 and self.coarse_centroids is not None:
            allowed = self.tree.centroid_allowed()  # [L, nc]
            qc = km.topm_centroids(
                workload.vectors, self.coarse_centroids, self.m_fanout,
                metric=self.db.metric, device=self.device,
            )  # [m, mfan]
            # query ok in leaf iff any of its m centroids is allowed there
            onehot = np.zeros((workload.m, allowed.shape[1]), dtype=bool)
            rows = np.repeat(np.arange(workload.m), qc.shape[1])
            onehot[rows, qc.reshape(-1)] = True
            qcent_ok = (onehot @ allowed.T.astype(np.int64)) > 0  # [m, L]
        return troutes, qcent_ok


class HQIIndex:
    def __init__(
        self,
        db: VectorDatabase,
        tree: QDTree,
        partitions: List[Partition],
        cfg: HQIConfig,
        coarse_centroids: Optional[np.ndarray],
        build_info: BuildInfo,
        pq: Optional[PQCodebook] = None,
        device: km.Device = "cuda",
    ):
        if cfg.mesh is not None:
            raise NotImplementedError(MESH_NOT_PORTED)
        self.device = torch.device(device)
        self.db = db
        self.tree = tree
        self.partitions = partitions
        self.cfg = cfg
        self.coarse_centroids = coarse_centroids
        self.build_info = build_info
        self.pq = pq  # index-wide codebook (scan_mode="pq")
        self.router = Router(db, tree, coarse_centroids, cfg.m, device=self.device)
        self._arena: Optional[PackedArena] = None

    @property
    def arena(self) -> PackedArena:
        """Index-wide packed arena, materialized on first engine-backed search
        (the per-query-only configuration never pays the concatenation). When
        a codebook was loaded the arena also carries its uint8 PQ codes."""
        if self._arena is None:
            self._arena = PackedArena.from_partitions(
                [(p.rows, p.ivf) for p in self.partitions], pq=self.pq, device=self.device
            )
        return self._arena

    def attach_pq(self, pq: PQCodebook) -> None:
        """Attach a codebook to an index built without one (scan_mode="f32").

        Enables per-call ``search(scan_mode="pq")`` overrides (the serving
        layer's overload degradation) while default searches stay exact. An
        already-materialized arena is re-encoded in place.
        """
        self.pq = pq
        if self._arena is not None:
            self._arena.attach_pq(pq)

    # ------------------------------------------------------------------ build

    @staticmethod
    def build(
        db: VectorDatabase,
        workload_sample: Workload,
        cfg: Optional[HQIConfig] = None,
        device: Optional[km.Device] = None,
    ) -> "HQIIndex":
        """Build on ``device`` (default "cuda")."""
        cfg = HQIConfig() if cfg is None else cfg
        device = torch.device("cuda" if device is None else device)
        if cfg.mesh is not None:
            raise NotImplementedError(MESH_NOT_PORTED)
        if cfg.plan.scan_mode == "pq" and db.d % cfg.pq_m:
            raise ValueError(f"scan_mode='pq': d={db.d} not divisible by pq_m={cfg.pq_m}")
        info = BuildInfo()
        centroid_of = None
        query_centroids = None
        coarse = None
        if cfg.m > 0:
            t0 = time.perf_counter()
            coarse = km.train_kmeans(
                db.vectors, cfg.n_coarse_centroids, iters=cfg.kmeans_iters,
                metric=db.metric, seed=cfg.seed, device=device,
            )
            centroid_of = km.assign_kmeans(db.vectors, coarse, metric=db.metric, device=device)
            query_centroids = km.topm_centroids(
                workload_sample.vectors, coarse, cfg.m, metric=db.metric, device=device
            )
            info.coarse_seconds = time.perf_counter() - t0

        t0 = time.perf_counter()
        tree = build_qdtree(
            db,
            workload_sample,
            centroid_of=centroid_of,
            query_centroids=query_centroids,
            n_centroids=cfg.n_coarse_centroids if cfg.m > 0 else 0,
            min_size=cfg.min_partition_size,
            max_leaves=cfg.max_leaves,
            cost_mode=cfg.cost_mode,
        )
        info.qdtree_seconds = time.perf_counter() - t0

        t0 = time.perf_counter()
        partitions = []
        for leaf in tree.leaves:
            vecs = db.vectors[leaf.rows]
            nc = cfg.ivf_centroids or max(1, int(math.isqrt(len(leaf.rows))))
            ivf = IVFIndex.build(
                vecs, metric=db.metric, n_centroids=nc, kmeans_iters=cfg.kmeans_iters,
                seed=cfg.seed, device=device,
            )
            partitions.append(Partition(rows=leaf.rows, ivf=ivf))
        info.ivf_seconds = time.perf_counter() - t0

        pq_cb = None
        if cfg.plan.scan_mode == "pq":
            t0 = time.perf_counter()
            pq_cb = train_pq(
                db.vectors, cfg.pq_m, metric=db.metric,
                iters=cfg.kmeans_iters, seed=cfg.seed, device=device,
            )
            info.pq_seconds = time.perf_counter() - t0
        return HQIIndex(db, tree, partitions, cfg, coarse, info, pq=pq_cb, device=device)

    # ------------------------------------------------------------ batch search

    def _engine_tasks(
        self,
        workload: Workload,
        *,
        nprobe: Union[int, Dict[int, int]],
        batch_vec: Union[bool, str],
        stats: ScanStats,
        live_mask: Optional[np.ndarray] = None,
    ) -> Tuple[List[EngineTask], List[ExtraCandidates], Dict[int, int]]:
        """Route the workload into engine tasks + host-side per-query scans.

        Every routed (template × partition) product with a non-empty bitmap
        either joins the global plan (``EngineTask``) or — when the adaptive
        executor deems the group too small to amortize padding — runs as
        per-query scans whose top-ks are returned as extra merge candidates.
        The third return is the probe-heat map {partition: #queries routed
        there} across both paths (the drift monitor's per-partition feed).

        ``live_mask`` (bool [db.n]) is the serving layer's tombstone filter:
        it is ANDed into every template bitmap *after* the cache lookup, so
        deletes never invalidate the Router's bitmap cache.
        """
        troutes, qcent_ok = self.router.routes(workload)
        tasks: List[EngineTask] = []
        extra: List[ExtraCandidates] = []
        part_probes: Dict[int, int] = {}
        k = workload.k
        for ti, filt in enumerate(workload.templates):
            q_of_t = workload.queries_for_template(ti)
            if len(q_of_t) == 0:
                continue
            bitmap = self.router.template_bitmap(filt)
            if live_mask is not None:
                bitmap = bitmap & live_mask
            np_t = nprobe[ti] if isinstance(nprobe, dict) else nprobe
            for li in np.nonzero(troutes[ti])[0]:
                part = self.partitions[li]
                qidx = q_of_t
                if qcent_ok is not None:
                    qidx = q_of_t[qcent_ok[q_of_t, li]]
                if len(qidx) == 0:
                    continue
                local_bitmap = bitmap[part.rows]
                if not local_bitmap.any():
                    continue
                li_key = int(li)
                part_probes[li_key] = part_probes.get(li_key, 0) + len(qidx)
                use_batch = (
                    len(qidx) >= self.cfg.plan.adaptive_crossover
                    if batch_vec == "auto"
                    else bool(batch_vec)
                )
                if use_batch:
                    packed = None
                    if not local_bitmap.all():
                        packed = self.arena.packed_bitmap(int(li), local_bitmap)
                    tasks.append(
                        EngineTask(
                            part=int(li),
                            qrows=qidx.astype(np.int64),
                            nprobe=int(np_t),
                            packed_bitmap=packed,
                        )
                    )
                else:
                    s, loc = part.ivf.search_group(
                        workload.vectors[qidx], nprobe=np_t, k=k,
                        bitmap=local_bitmap, stats=stats,
                    )
                    gids = np.where(loc >= 0, part.rows[np.maximum(loc, 0)], -1)
                    extra.append((qidx.astype(np.int64), s, gids))
        return tasks, extra, part_probes

    def search(
        self,
        workload: Workload,
        *,
        nprobe: Union[int, Dict[int, int]] = 8,
        batch_vec: Union[bool, str] = True,
        live_mask: Optional[np.ndarray] = None,
        scan_mode: Optional[str] = None,
        refine_factor: Optional[int] = None,
    ) -> SearchResult:
        """Batch HVQ processing: one global plan, megabatched dispatch.

        batch_vec: True = all vector work through the engine (at most
        ``PlanConfig.max_bucket_shapes`` kernel dispatches per workload);
        False = per-query scans; "auto" = the adaptive executor the paper's
        §6.5 calls for — a (template × partition) group joins the global plan
        only when it is large enough to amortize the work-unit padding
        (PlanConfig.adaptive_crossover).

        live_mask: optional bool [db.n] of rows still alive — the serving
        layer's tombstones; dead rows are excluded from every result exactly.

        scan_mode / refine_factor: per-call overrides of the build-time plan
        config: the serving layer's overload degradation sheds an exact f32
        deployment to ``scan_mode="pq"`` per flush without touching the
        index. ``scan_mode="pq"`` needs a codebook (``attach_pq`` adds one
        to an f32-built index).
        """
        plan_cfg = self.cfg.plan
        if scan_mode is not None or refine_factor is not None:
            if (scan_mode or plan_cfg.scan_mode) == "pq" and self.pq is None:
                raise ValueError(
                    "scan_mode='pq' override needs a codebook: HQIIndex.attach_pq() first"
                )
            plan_cfg = dataclasses.replace(
                plan_cfg,
                scan_mode=plan_cfg.scan_mode if scan_mode is None else scan_mode,
                refine_factor=(
                    plan_cfg.refine_factor
                    if refine_factor is None
                    else int(refine_factor)
                ),
            )
        m, k = workload.m, workload.k
        stats = ScanStats()
        tracer = get_tracer()
        with tracer.span("engine.route", m=m, templates=len(workload.templates)):
            tasks, extra, part_probes = self._engine_tasks(
                workload, nprobe=nprobe, batch_vec=batch_vec, stats=stats,
                live_mask=live_mask,
            )
        # the all-per-query path (batch_vec=False) never touches the arena
        arena = self.arena if tasks else None
        with tracer.span("plan.build", tasks=len(tasks)):
            plan = build_plan(
                arena, tasks, workload.vectors, m=m, k=k, cfg=plan_cfg, stats=stats
            )
        with tracer.span(
            "plan.execute", buckets=len(plan.buckets), extras=len(extra)
        ):
            run_s, run_i = execute_plan(
                plan, arena, workload.vectors, cfg=plan_cfg, extra=extra, stats=stats,
                device=self.device,
            )
        return SearchResult(
            ids=run_i,
            scores=run_s,
            tuples_scanned=stats.tuples_scanned,
            bytes_scanned=stats.bytes_scanned,
            peak_candidate_bytes=stats.peak_candidate_bytes,
            lut_bytes=stats.lut_bytes,
            part_probes=part_probes,
        )

    # ------------------------------------------------------------ online search

    def search_online(
        self,
        workload: Workload,
        *,
        nprobe: Union[int, Dict[int, int]] = 8,
        live_mask: Optional[np.ndarray] = None,
    ) -> SearchResult:
        """One query at a time (workload-aware index w/o batching, Section 6.5)."""
        return self.search(workload, nprobe=nprobe, batch_vec=False, live_mask=live_mask)

    # ------------------------------------------------------------ live updates

    def invalidate_caches(self) -> None:
        """Drop every derived structure that depends on DB contents.

        The serving layer calls this after any mutation that changes row
        count or vector contents: the Router's template bitmaps are length-
        [db.n] and the arena holds a copy of every partition's packed
        vectors, so both must be rebuilt. (Pure deletes don't need this —
        they flow through ``live_mask`` at search time.)
        """
        self.router.clear_cache()
        self._arena = None

    def extend(self, new_db: VectorDatabase) -> np.ndarray:
        """Fold freshly inserted tuples into the existing partitioning.

        The serving layer's ``refresh()`` path: routes each new tuple to its
        unique qd-tree leaf (semantic-description membership, no Algorithm-1
        re-run), assigns it to that partition's nearest existing posting list
        (``IVFIndex.extend`` on the index's device — no k-means), and
        incrementally rebuilds the arena reusing unchanged partitions. The
        qd-tree structure itself is a build-time artifact mined from the
        historical workload and is kept.

        Returns the new tuples' global row ids (``old_n .. old_n + new - 1``).
        The Router bitmap cache is always invalidated (bitmaps are [db.n]).
        """
        n0 = self.db.n
        new_rows = n0 + np.arange(new_db.n, dtype=np.int64)
        if new_db.n == 0:
            return new_rows
        cent_new = None
        if self.cfg.m > 0 and self.coarse_centroids is not None:
            cent_new = km.assign_kmeans(
                new_db.vectors, self.coarse_centroids, metric=self.db.metric,
                device=self.device,
            )
        leaf_of = self.tree.route_tuples(new_db, cent_new)
        self.db = VectorDatabase.concat(self.db, new_db)
        self.router.db = self.db
        self.router.clear_cache()
        changed = []
        for li in np.unique(leaf_of):
            li = int(li)
            idx = np.nonzero(leaf_of == li)[0]
            part = self.partitions[li]
            self.partitions[li] = Partition(
                rows=np.concatenate([part.rows, new_rows[idx]]),
                ivf=part.ivf.extend(new_db.vectors[idx]),
            )
            # keep the build-time alias (Partition.rows IS the leaf's row set)
            self.tree.leaves[li].rows = self.partitions[li].rows
            changed.append(li)
        if self._arena is not None:
            self._arena = PackedArena.updated(
                self._arena, [(p.rows, p.ivf) for p in self.partitions], changed
            )
        return new_rows

    # ------------------------------------------------------------ persistence

    def to_state(self) -> dict:
        """Snapshot state (store/snapshot.py): everything a warm restart
        needs — DB columns, qd-tree, per-partition IVFs, coarse centroids,
        PQ codebook, the materialized arena (rows + posting-list table +
        uint8 codes), and the Router's template bitmap cache — so a loaded
        index answers bit-identically to this one with no recompute.
        """
        cached = list(self.router._bitmap_cache.items())
        return {
            "cfg": self.cfg.to_state(),
            "db": self.db.to_state(),
            "tree": self.tree.to_state(),
            "partitions": [
                {"rows": p.rows, "ivf": p.ivf.to_state()} for p in self.partitions
            ],
            "coarse_centroids": self.coarse_centroids,
            "pq": None if self.pq is None else self.pq.to_state(),
            "build_info": dataclasses.asdict(self.build_info),
            # materialize so the snapshot serves engine searches immediately
            # after load (no O(N·d) concatenation / O(N·M) re-encode)
            "arena": self.arena.to_state(),
            "router_cache": {
                "filters": [filter_to_state(f) for f, _ in cached],
                "bitmaps": (
                    np.stack([bm for _, bm in cached])
                    if cached
                    else np.zeros((0, self.db.n), dtype=bool)
                ),
            },
        }

    @staticmethod
    def from_state(state: dict, device: Optional[km.Device] = None) -> "HQIIndex":
        """Load a saved index (this package's or the reference's
        ``to_state()``) onto ``device`` (default "cuda")."""
        device = torch.device("cuda" if device is None else device)
        index = HQIIndex(
            db=VectorDatabase.from_state(state["db"]),
            tree=QDTree.from_state(state["tree"]),
            partitions=[
                Partition(
                    rows=np.asarray(ps["rows"]),
                    ivf=IVFIndex.from_state(ps["ivf"], device=device),
                )
                for ps in state["partitions"]
            ],
            cfg=HQIConfig.from_state(state["cfg"]),
            coarse_centroids=(
                None
                if state["coarse_centroids"] is None
                else np.asarray(state["coarse_centroids"])
            ),
            build_info=BuildInfo(**state["build_info"]),
            pq=None if state["pq"] is None else PQCodebook.from_state(state["pq"]),
            device=device,
        )
        index._arena = PackedArena.from_state(state["arena"], device=device)
        cache = state["router_cache"]
        bitmaps = np.asarray(cache["bitmaps"])
        for fi, fs in enumerate(cache["filters"]):
            index.router._bitmap_cache[filter_from_state(fs)] = bitmaps[fi]
        return index
