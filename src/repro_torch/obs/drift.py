"""Workload-drift monitor: the sensor the hot-swap index tuner reads.

The paper's thesis is that the index layout should follow the *workload* —
but the qd-tree/IVF layout is frozen at build time while live traffic moves.
``DriftMonitor`` watches the serving stream and answers the four questions a
re-partitioning tuner has to ask before spending a rebuild:

  1. **Template traffic** — a sliding window of per-query filter templates;
     ``report()`` splits the window in half and scores the total-variation
     distance between the older and recent halves' template shares
     (``share_shift`` in [0, 1]: 0 = stationary mix, 1 = disjoint mixes).
  2. **Probe heat** — per-partition routed-query counts over recent flushes,
     normalized to shares: a hot partition is a split candidate, a cold one
     a merge candidate.
  3. **Delta growth** — cumulative delta-store rows over time → rows/s, i.e.
     how fast the frozen layout is going stale.
  4. **Recall health** — a small reservoir sample of *answered* queries
     (vector, filter, served ids); ``live_recall`` replays them against a
     brute-force scan of the service's current live DB and scores overlap.
     This is ground truth — if it sags, nprobe/layout tuning is overdue.

Everything is O(window) memory and lock-protected (the scheduler thread
feeds it while callers read reports). The module stays import-light: heavy
deps (numpy at module level is fine; ``core.baselines`` for the recall
probe) load lazily so ``repro_torch.obs`` never drags the engine in by accident.
"""
from __future__ import annotations

import dataclasses
import json
import random
import threading
import time
from collections import Counter, deque
from typing import Any, Dict, Hashable, Iterable, List, Optional, Tuple

import numpy as np

__all__ = ["DriftConfig", "DriftMonitor", "DriftReport"]


@dataclasses.dataclass
class DriftConfig:
    window: int = 4096  # per-query template observations retained
    heat_window: int = 256  # per-flush probe-heat observations retained
    growth_window: int = 256  # (t, delta_rows) samples retained
    reservoir: int = 64  # answered queries kept for the recall probe
    seed: int = 0  # reservoir RNG (deterministic for tests)


@dataclasses.dataclass
class DriftReport:
    """One point-in-time reading; the hot-swap tuner consumes this verbatim."""

    n_window: int  # template observations backing the shares
    window_span_s: float  # wall-time the window covers
    template_shares: Dict[str, float]  # recent-half traffic share per template
    reference_shares: Dict[str, float]  # older-half traffic share per template
    share_shift: float  # total-variation distance, recent vs older half
    part_heat: Dict[int, float]  # partition -> share of routed queries
    delta_rows: int  # current delta-store row count
    delta_growth_per_s: float  # delta rows per second over the growth window
    recall_at_k: Optional[float] = None  # live recall probe (None = not run)
    recall_k: int = 0
    recall_samples: int = 0

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(dataclasses.asdict(self), indent=indent)


def _shares(counts: Counter) -> Dict[str, float]:
    total = sum(counts.values())
    if total == 0:
        return {}
    return {str(k): c / total for k, c in sorted(counts.items(), key=lambda kv: str(kv[0]))}


def _tv_distance(a: Dict[str, float], b: Dict[str, float]) -> float:
    keys = set(a) | set(b)
    return 0.5 * sum(abs(a.get(k, 0.0) - b.get(k, 0.0)) for k in keys)


class DriftMonitor:
    """Sliding-window workload observer (thread-safe)."""

    def __init__(self, cfg: Optional[DriftConfig] = None) -> None:
        self.cfg = DriftConfig() if cfg is None else cfg
        self._lock = threading.Lock()
        self._queries: deque = deque(maxlen=self.cfg.window)  # (t, template_key)
        self._heat: deque = deque(maxlen=self.cfg.heat_window)  # {part: count}
        # (t, cumulative inserts) — see observe_delta for the fold handling
        self._growth: deque = deque(maxlen=self.cfg.growth_window)
        self._growth_base = 0  # rows folded out of the buffer so far
        self._last_delta_rows = 0  # most recent raw buffer row count
        self._reservoir: List[Tuple[np.ndarray, tuple, np.ndarray]] = []
        self._seen = 0  # queries offered to the reservoir
        self._rng = random.Random(self.cfg.seed)

    # ----------------------------------------------------------------- feeding

    def observe_queries(self, keys: Iterable[Hashable], t: Optional[float] = None) -> None:
        """One entry per answered query; ``keys`` are template identities
        (filter tuples are frozen-dataclass tuples, hence hashable)."""
        now = time.monotonic() if t is None else t
        with self._lock:
            for k in keys:
                self._queries.append((now, k))

    def observe_probes(self, part_counts: Dict[int, int]) -> None:
        """Per-flush routed-query count per partition (engine ``part_probes``)."""
        if not part_counts:
            return
        with self._lock:
            self._heat.append(dict(part_counts))

    def observe_delta(self, rows: int, t: Optional[float] = None) -> None:
        """Current delta-store row count (the raw buffer size each flush sees).

        The buffer resets to zero at every refresh fold, so the raw series is
        sawtoothed — differencing it directly would report *negative* growth
        across a fold. The monitor detects the reset (``rows`` shrank) and
        maintains a monotone cumulative-inserts series instead: growth over
        the window is always ≥ 0 and ≈ the true insert rate. (Rows inserted
        AND folded between two observations are invisible to any sampler and
        are undercounted; flush-rate sampling keeps that gap negligible.)
        """
        now = time.monotonic() if t is None else t
        rows = int(rows)
        with self._lock:
            if rows < self._last_delta_rows:
                # fold detected: everything previously buffered left the
                # delta; rows present now arrived after the fold
                self._growth_base += self._last_delta_rows
            self._last_delta_rows = rows
            self._growth.append((now, self._growth_base + rows))

    def maybe_sample(self, vector: np.ndarray, filt: tuple, served_ids: np.ndarray) -> None:
        """Reservoir-sample an answered query for the live recall probe."""
        with self._lock:
            self._seen += 1
            entry = (
                np.array(vector, dtype=np.float32, copy=True),
                filt,
                np.array(served_ids, dtype=np.int64, copy=True),
            )
            if len(self._reservoir) < self.cfg.reservoir:
                self._reservoir.append(entry)
            else:
                j = self._rng.randrange(self._seen)
                if j < self.cfg.reservoir:
                    self._reservoir[j] = entry

    # ---------------------------------------------------------------- reading

    def traffic_snapshot(
        self,
    ) -> Tuple[
        List[Tuple[float, Hashable]], List[Tuple[np.ndarray, tuple, np.ndarray]]
    ]:
        """(template window, reservoir) — the RAW observations, filter tuples
        and sampled query vectors intact. ``DriftReport`` stringifies template
        keys for JSON; workload reconstruction (``core.workload.
        reconstruct_workload``, consumed by the hot-swap tuner) needs the
        actual filters back, so it reads this instead."""
        with self._lock:
            return list(self._queries), list(self._reservoir)

    def reset(self) -> None:
        """Forget every observation (window, heat, growth, reservoir).

        Called after an index swap: the retained traffic and served answers
        describe the *displaced* layout, and a share-shift computed across
        the swap boundary would immediately re-trigger the tuner on its own
        rebuild."""
        with self._lock:
            self._queries.clear()
            self._heat.clear()
            self._growth.clear()
            self._growth_base = 0
            self._last_delta_rows = 0
            self._reservoir = []
            self._seen = 0

    def live_recall(self, service: Any, k: Optional[int] = None) -> Optional[Tuple[float, int, int]]:
        """(recall@k, k, n_samples) replaying the reservoir against a
        brute-force scan of ``service``'s live DB; None when nothing sampled.

        Ground truth, not an estimate: ``exhaustive_search`` over
        ``service.snapshot_db()`` (indexed + delta rows minus tombstones), on
        the service index's device.
        Positions map through ``db.ids`` back to the global ids the service
        serves. Reservoir entries sampled before deletes may legitimately
        hold now-dead ids — that recall loss is real and should be reported.
        """
        from ..core.baselines import exhaustive_search  # lazy: keep obs light
        from ..core.types import Workload

        with self._lock:
            sample = list(self._reservoir)
        if not sample:
            return None
        db = service.snapshot_db()
        if db.n == 0:
            return None
        kk = int(k if k is not None else service.cfg.k)
        queries = np.stack([v for v, _, _ in sample])
        interned: Dict[tuple, int] = {}
        template_of = np.empty(len(sample), dtype=np.int32)
        for i, (_, filt, _) in enumerate(sample):
            template_of[i] = interned.setdefault(filt, len(interned))
        templates: List[tuple] = [None] * len(interned)  # type: ignore[list-item]
        for f, ti in interned.items():
            templates[ti] = f
        wl = Workload(vectors=queries, templates=templates, template_of=template_of, k=kk)
        truth = exhaustive_search(db, wl, device=service.index.device)
        hits = 0
        denom = 0
        for i, (_, _, served) in enumerate(sample):
            pos = truth.ids[i]
            true_gids = set(int(g) for g in db.ids[pos[pos >= 0]])
            if not true_gids:
                continue
            denom += len(true_gids)
            hits += len(true_gids & set(int(g) for g in served if g >= 0))
        if denom == 0:
            return None
        return hits / denom, kk, len(sample)

    def report(
        self,
        service: Any = None,
        *,
        probe_recall: bool = False,
        k: Optional[int] = None,
    ) -> DriftReport:
        """Current ``DriftReport``; set ``probe_recall=True`` (with the
        service) to also run the brute-force recall probe — it scans the
        live DB, so leave it off on latency-sensitive paths."""
        with self._lock:
            q = list(self._queries)
            heat = list(self._heat)
            growth = list(self._growth)
            delta_rows = self._last_delta_rows
        half = len(q) // 2
        older = Counter(key for _, key in q[:half])
        recent = Counter(key for _, key in q[half:])
        ref_shares = _shares(older)
        rec_shares = _shares(recent)
        shift = _tv_distance(rec_shares, ref_shares) if older and recent else 0.0
        heat_counts: Counter = Counter()
        for pc in heat:
            heat_counts.update(pc)
        heat_total = sum(heat_counts.values())
        part_heat = (
            {int(p): c / heat_total for p, c in sorted(heat_counts.items())}
            if heat_total
            else {}
        )
        # growth entries are (t, cumulative inserts) — monotone across folds
        # (see observe_delta), so the window rate can never go negative
        growth_per_s = 0.0
        if len(growth) >= 2:
            dt = growth[-1][0] - growth[0][0]
            if dt > 0:
                growth_per_s = (growth[-1][1] - growth[0][1]) / dt
        span = (q[-1][0] - q[0][0]) if len(q) >= 2 else 0.0
        recall = None
        rk = 0
        rn = 0
        if probe_recall and service is not None:
            probed = self.live_recall(service, k=k)
            if probed is not None:
                recall, rk, rn = probed
                # publish so recall Objectives (obs.metrics) have a live
                # instrument to watch between reports
                from .metrics import get_registry

                get_registry().gauge("service.live_recall").set(recall)
        return DriftReport(
            n_window=len(q),
            window_span_s=span,
            template_shares=rec_shares,
            reference_shares=ref_shares,
            share_shift=shift,
            part_heat=part_heat,
            delta_rows=delta_rows,
            delta_growth_per_s=growth_per_s,
            recall_at_k=recall,
            recall_k=rk,
            recall_samples=rn,
        )
