"""Background index evolution: drift-triggered rebuild + blue/green swap.

The paper's central claim is that the index layout should be *workload-
aware* — but the qd-tree/IVF partitioning is mined from a historical
workload at build time, and live traffic moves. ``obs.drift.DriftMonitor``
already measures exactly when the frozen layout goes stale;
``store.snapshot`` generations are exactly the mechanism for introducing a
new layout atomically. ``Tuner`` closes the loop:

  1. **watch** — poll ``HQIService.drift_report()`` against trigger
     thresholds: template-mix ``share_shift``, live-recall sag, delta-growth
     rate (how fast the layout is going stale under ingest);
  2. **rebuild off to the side** — reconstruct a representative ``Workload``
     from the drift window's observed traffic (``core.workload.
     reconstruct_workload``), then re-run the full build — qd-tree routing,
     IVF, ``PackedArena``, PQ carry-over, per-template ``tune_nprobe`` —
     against a captured copy of the serving state, on the serving index's
     device beside the live service, holding **no** service lock while the
     heavy work runs. The build covers the *full* captured
     row space (dead rows included, same order), so global ids — which are
     row positions — never renumber and post-swap answers stay bit-identical;
  3. **persist** — write the candidate layout as a snapshot generation
     stamped with the WAL seq it covers, WITHOUT flipping ``CURRENT``
     (blue/green: a failed swap must leave restarts on the serving layout);
  4. **swap** — ``HQIService.swap_index`` under the flush lock: in-flight
     batches drained on the old index, acked writes past the build's seq
     replayed from the WAL into a fresh ``DeltaStore`` on the new index,
     caches invalidated, zero dropped queries. Only then is the generation
     promoted (``set_current``) and the displaced one pinned on disk for
     instant ``rollback()``.

Fault containment mirrors the rest of ``repro_torch.fault``: the ``tuner.build``
and ``tuner.swap`` failpoints fire before any serving state is touched, so
a faulted build or swap leaves the old index serving untouched, and the
background loop backs off exponentially like the ``Compactor``'s.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.hqi import HQIIndex
from ..core.metrics import tune_nprobe
from ..core.types import SearchResult, VectorDatabase, Workload
from ..core.workload import reconstruct_workload
from ..fault.failpoints import failpoint
from ..obs.drift import DriftReport
from ..obs.metrics import get_registry
from ..obs.trace import get_tracer, set_thread_name
from ..service.service import HQIService
from ..store.snapshot import (
    build_state,
    current_generation,
    pin_generation,
    set_current,
    unpin_generation,
    write_generation,
)


@dataclasses.dataclass
class TunerConfig:
    # ---- trigger thresholds (None disables that trigger) ----
    share_shift: Optional[float] = 0.35  # TV distance, recent vs older half
    recall_floor: Optional[float] = None  # live recall@k below this trips
    delta_growth_per_s: Optional[float] = None  # ingest rate above this trips
    min_window: int = 64  # drift observations required before any trigger
    min_interval_s: float = 0.0  # cooldown between swaps (rebuilds are heavy)
    # ---- rebuild ----
    workload_queries: int = 256  # reconstructed-workload size
    retune_nprobe: bool = True  # re-run tune_nprobe on the new layout
    target_recall: float = 0.8  # the paper's Recall >= 0.8 @ k protocol
    max_nprobe: int = 256
    sample_per_template: int = 64
    seed: int = 0
    # ---- lifecycle ----
    interval_s: float = 30.0  # background poll period
    max_backoff_s: float = 300.0  # cap on the failure backoff
    keep_rollback: bool = True  # pin the displaced generation on disk


@dataclasses.dataclass
class SwapRecord:
    """One completed rebuild + blue/green swap (``Tuner.swaps`` keeps them)."""

    reason: str  # which trigger fired ("share-shift" | "recall-sag" | ...)
    generation: Optional[str]  # persisted candidate generation (None: no root)
    covered_seq: int  # highest WAL seq the rebuild includes
    n_rows: int  # row count of the rebuilt index (dead rows included)
    replayed: int  # WAL records replayed into the fresh delta at swap
    nprobe_by_filter: Optional[Dict[tuple, int]]  # tuned overrides installed
    build_s: float  # off-to-the-side rebuild wall time
    swap_s: float  # under-flush-lock swap wall time


@dataclasses.dataclass
class _Build:
    """A candidate layout waiting to be swapped in (internal)."""

    index: HQIIndex
    live: np.ndarray  # tombstone mask over ALL rebuilt rows
    covered_seq: int  # _applied_seq at capture
    nprobe_by_filter: Optional[Dict[tuple, int]]
    generation: Optional[str]
    reason: str
    build_s: float


class Tuner:
    """Drift-triggered index evolution for one ``HQIService``.

    Drive it synchronously (``tune_once``) or as a daemon thread
    (``start``/``stop``) — same lifecycle contract as ``store.compact.
    Compactor``, including failure accounting (``consecutive_failures`` /
    ``last_error`` feed ``HQIService.health()``) and exponential backoff.
    ``root`` is the snapshot store root for generation persistence; None
    runs purely in memory (no durability, still zero-downtime swaps).
    """

    def __init__(
        self,
        service: HQIService,
        root: Optional[str] = None,
        *,
        cfg: Optional[TunerConfig] = None,
    ) -> None:
        self.service = service
        self.root = root
        self.cfg = TunerConfig() if cfg is None else cfg
        self.swaps: List[SwapRecord] = []
        self.consecutive_failures = 0
        self.last_error: Optional[BaseException] = None
        self.last_reason: Optional[str] = None
        self._last_swap_t: Optional[float] = None
        # (old_index, old_live, old_covered_seq, old_gen, new_gen) — what
        # rollback() swaps back in; kept until the next successful swap
        self._rollback: Optional[tuple] = None
        self._thread: Optional[threading.Thread] = None
        self._stop_flag = threading.Event()
        get_registry().attach_source("tuner", self._metrics)
        service._tuner = self  # health() back-ref, like the compactor's

    def _metrics(self) -> dict:
        return {
            "swaps": len(self.swaps),
            "consecutive_failures": self.consecutive_failures,
            "last_error": None if self.last_error is None else repr(self.last_error),
            "last_reason": self.last_reason,
            "rollback_armed": self._rollback is not None,
            "backoff_s": self._backoff_s(),
        }

    def _backoff_s(self) -> float:
        if self.consecutive_failures == 0:
            return self.cfg.interval_s
        return min(
            self.cfg.max_backoff_s,
            self.cfg.interval_s * (2.0 ** self.consecutive_failures),
        )

    # ---------------------------------------------------------------- trigger

    def should_rebuild(self, report: DriftReport) -> Optional[str]:
        """The trigger reason a report trips, or None (also None inside the
        ``min_interval_s`` cooldown — rebuilds are heavy, and the drift
        window right after a swap describes almost no traffic anyway)."""
        cfg = self.cfg
        if report.n_window < cfg.min_window:
            return None
        if (
            self._last_swap_t is not None
            and time.monotonic() - self._last_swap_t < cfg.min_interval_s
        ):
            return None
        if cfg.share_shift is not None and report.share_shift >= cfg.share_shift:
            return "share-shift"
        if (
            cfg.recall_floor is not None
            and report.recall_at_k is not None
            and report.recall_at_k < cfg.recall_floor
        ):
            return "recall-sag"
        if (
            cfg.delta_growth_per_s is not None
            and report.delta_growth_per_s >= cfg.delta_growth_per_s
        ):
            return "delta-growth"
        return None

    # ------------------------------------------------------------------- once

    def tune_once(self, force: bool = False) -> Optional[SwapRecord]:
        """One watch → rebuild → swap cycle; returns the record, or None when
        no trigger fired. ``force=True`` skips the trigger check (operator
        'rebuild now'). Failure accounting lives here so synchronously driven
        tuners report the same health as the background loop."""
        try:
            rec = self._tune_once(force)
        except Exception as e:
            self.consecutive_failures += 1
            self.last_error = e
            raise
        else:
            self.consecutive_failures = 0
            self.last_error = None
            return rec

    def _tune_once(self, force: bool) -> Optional[SwapRecord]:
        report = self.service.drift_report(
            probe_recall=self.cfg.recall_floor is not None
        )
        reason = "forced" if force else self.should_rebuild(report)
        if reason is None:
            return None
        built = self._build(reason)
        return self._swap(built)

    # ------------------------------------------------------------------ build

    def _build(self, reason: str) -> _Build:
        """Rebuild the layout off to the side; no service lock held while the
        heavy work (k-means, arena packing, nprobe tuning, blob I/O) runs.

        Id-space preservation is the load-bearing invariant: the new index is
        built over the FULL captured DB — base rows plus delta rows, dead
        rows *included*, same order — so global ids (row positions) never
        renumber and the swap can replay the WAL tail on top with bit-exact
        id continuity. Dead rows stay invisible exactly as they already were:
        through the live mask at search time.
        """
        svc = self.service
        t0 = time.perf_counter()
        with get_tracer().span("tuner.build", reason=reason):
            failpoint("tuner.build")
            with svc._lock:
                # refs only — index mutations are array replacements, so the
                # captured objects stay immutable after the lock drops
                base_db = svc.index.db
                base_live = svc._live.copy()
                delta_db, delta_live = svc.delta.snapshot()
                covered_seq = svc._applied_seq
                index_cfg = svc.index.cfg
                old_pq = svc.index.pq
            prev_pin = None
            if svc.wal is not None:
                # shield the tail the swap must replay from a concurrent
                # compactor's WAL pruning for the whole build
                prev_pin = svc.wal.pin_seq
                svc.wal.pin_seq = (
                    covered_seq if prev_pin is None else min(prev_pin, covered_seq)
                )
            try:
                full_db = (
                    base_db
                    if delta_db is None
                    else VectorDatabase.concat(base_db, delta_db)
                )
                full_live = np.concatenate([base_live, delta_live])
                wl = self._reconstruct(full_db, full_live)
                new_index = HQIIndex.build(full_db, wl, index_cfg, device=svc.index.device)
                if old_pq is not None and new_index.pq is None:
                    # the codebook is trained on vector space, not layout —
                    # carry it over so degraded-mode serving survives the swap
                    new_index.attach_pq(old_pq)
                by_filter = None
                if self.cfg.retune_nprobe:
                    by_filter = self._retune(new_index, full_db, full_live, wl)
                gen = None
                if self.root is not None:
                    gen = write_generation(
                        self.root,
                        build_state(new_index, live=full_live),
                        wal_seq=covered_seq,
                        meta={"source": "tuner", "reason": reason},
                        set_current=False,  # promote only after the swap lands
                    )
            except BaseException:
                if svc.wal is not None:
                    svc.wal.pin_seq = prev_pin
                raise
        return _Build(
            index=new_index,
            live=full_live,
            covered_seq=covered_seq,
            nprobe_by_filter=by_filter,
            generation=gen,
            reason=reason,
            build_s=time.perf_counter() - t0,
        )

    def _reconstruct(self, full_db: VectorDatabase, full_live: np.ndarray) -> Workload:
        """Representative workload from observed traffic (recent half of the
        drift window + the recall reservoir's real query vectors); falls back
        to an unfiltered self-similarity sample when nothing was observed
        (forced rebuild on an idle service)."""
        traffic, samples = self.service.drift.traffic_snapshot()
        recent = traffic[len(traffic) // 2 :]
        live_idx = np.nonzero(full_live)[0]
        fallback = full_db.vectors[live_idx] if len(live_idx) else full_db.vectors
        wl = reconstruct_workload(
            recent,
            samples,
            fallback_vectors=fallback,
            n_queries=self.cfg.workload_queries,
            k=self.service.cfg.k,
            seed=self.cfg.seed,
        )
        if wl is not None:
            return wl
        rng = np.random.default_rng(self.cfg.seed)
        m = min(self.cfg.workload_queries, max(1, len(fallback)))
        return Workload(
            vectors=fallback[rng.integers(0, len(fallback), size=m)],
            templates=[()],
            template_of=np.zeros(m, dtype=np.int32),
            k=self.service.cfg.k,
        )

    def _retune(
        self,
        new_index: HQIIndex,
        full_db: VectorDatabase,
        full_live: np.ndarray,
        wl: Workload,
    ) -> Dict[tuple, int]:
        """Per-template nprobe on the NEW layout (the paper's Recall >= 0.8
        protocol), returned keyed by filter tuple — template indices are
        flush-local in the service, filters are not."""
        from ..core.baselines import exhaustive_search  # lazy: engine dep

        live_idx = np.nonzero(full_live)[0]
        truth = exhaustive_search(full_db.take(live_idx), wl, device=new_index.device)
        # exhaustive ids are positions into the live-only view; the index
        # serves global ids — map through live_idx before comparing
        gids = np.where(truth.ids >= 0, live_idx[truth.ids], -1)
        truth = SearchResult(ids=gids, scores=truth.scores)

        def search_fn(sub: Workload, npr: Dict[int, int]) -> SearchResult:
            return new_index.search(sub, nprobe=npr, live_mask=full_live)

        per_template = tune_nprobe(
            search_fn,
            wl,
            truth,
            target_recall=self.cfg.target_recall,
            max_nprobe=self.cfg.max_nprobe,
            sample_per_template=self.cfg.sample_per_template,
            seed=self.cfg.seed,
        )
        return {
            filt: per_template[ti] for ti, filt in enumerate(wl.templates)
        }

    # ------------------------------------------------------------------- swap

    def _swap(self, built: _Build) -> SwapRecord:
        svc = self.service
        t0 = time.perf_counter()
        prev_gen = None if self.root is None else current_generation(self.root)
        with get_tracer().span("tuner.swap", reason=built.reason):
            old_index, old_live, old_seq, replayed = svc.swap_index(
                built.index, built.live, built.covered_seq
            )
        swap_s = time.perf_counter() - t0
        # ---- the swap landed: promote the candidate generation and arm the
        # rollback. A crash between here and the pin still restarts correctly
        # (CURRENT now names the layout that is serving).
        if self.root is not None and built.generation is not None:
            set_current(self.root, built.generation)
            if self._rollback is not None and self._rollback[3] is not None:
                unpin_generation(self.root, self._rollback[3])
            if self.cfg.keep_rollback and prev_gen is not None:
                pin_generation(self.root, prev_gen)
        if svc.wal is not None:
            # rollback replays records past the OLD folded seq; keep them
            svc.wal.pin_seq = old_seq if self.cfg.keep_rollback else None
        if built.nprobe_by_filter is not None:
            svc.set_nprobe_by_filter(built.nprobe_by_filter)
        self._rollback = (
            old_index,
            old_live,
            old_seq,
            prev_gen if self.cfg.keep_rollback else None,
            built.generation,
        )
        self._last_swap_t = time.monotonic()
        self.last_reason = built.reason
        rec = SwapRecord(
            reason=built.reason,
            generation=built.generation,
            covered_seq=built.covered_seq,
            n_rows=built.index.db.n,
            replayed=replayed,
            nprobe_by_filter=built.nprobe_by_filter,
            build_s=built.build_s,
            swap_s=swap_s,
        )
        self.swaps.append(rec)
        return rec

    @property
    def can_rollback(self) -> bool:
        """True while a displaced layout is held for instant ``rollback()``."""
        return self._rollback is not None

    def rollback(self) -> None:
        """Instantly swap the displaced layout back in (same blue/green
        mechanism, in reverse). Writes acknowledged after the forward swap
        are preserved: the WAL tail past the old layout's covered seq —
        pinned on disk since the swap — replays into its fresh delta, and
        the displaced index may even have grown via folds during the build;
        the replay handles both generically because the id space is shared.
        """
        if self._rollback is None:
            raise RuntimeError("no swap to roll back")
        old_index, old_live, old_seq, old_gen, new_gen = self._rollback
        svc = self.service
        svc.swap_index(old_index, old_live, old_seq)
        if self.root is not None and old_gen is not None:
            set_current(self.root, old_gen)
            unpin_generation(self.root, old_gen)
        if svc.wal is not None:
            svc.wal.pin_seq = None
        svc.set_nprobe_by_filter(None)
        self._rollback = None
        self.last_reason = "rollback"

    def forget_rollback(self) -> None:
        """Release the rollback pin (disk + WAL) once the new layout has
        proven itself; the next generation prune collects the old one."""
        if self._rollback is None:
            return
        old_gen = self._rollback[3]
        if self.root is not None and old_gen is not None:
            unpin_generation(self.root, old_gen)
        if self.service.wal is not None:
            self.service.wal.pin_seq = None
        self._rollback = None

    # ------------------------------------------------------------ background

    def start(self) -> None:
        """Poll ``tune_once`` on a daemon thread every ``interval_s``."""
        assert self._thread is None, "tuner already running"
        self._stop_flag.clear()

        def loop() -> None:
            set_thread_name("tuner")  # root spans tagged for trace triage
            while not self._stop_flag.wait(self._backoff_s()):
                try:
                    self.tune_once()
                except Exception:
                    # the service must outlive its tuner: tune_once already
                    # recorded last_error / consecutive_failures, and the
                    # next wait backs off exponentially. Crucially a failed
                    # build or swap left the old index serving untouched.
                    pass

        self._thread = threading.Thread(target=loop, name="hqi-tuner", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._thread is not None:
            self._stop_flag.set()
            self._thread.join()
            self._thread = None
