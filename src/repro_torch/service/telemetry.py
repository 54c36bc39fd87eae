"""Serving telemetry: latency percentiles, queue depth, dispatch accounting.

Every flush records its size, the queue depth it left behind, how many kernel
dispatches it cost (via the thread-safe ``kernels.ops.DispatchStats``
snapshots the service takes around each flush), and the per-query
submit→answer latencies. ``summary()`` reduces that to the numbers an
operator watches: p50/p99 latency, mean flush size, dispatches per flush,
peak queue depth, sustained QPS.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Deque, Dict, List, Sequence


@dataclasses.dataclass
class FlushRecord:
    size: int  # real (non-padded) queries answered
    queue_depth: int  # queries still pending after the flush
    knn_dispatches: int
    merge_dispatches: int
    seconds: float  # wall time of the flush's answer pipeline
    # memory observability: the flush's largest candidate merge buffer and
    # the ADC LUT bytes it materialized (0 for f32 scans)
    peak_candidate_bytes: int = 0
    lut_bytes: int = 0


class ServiceTelemetry:
    """Thread-safe accumulator shared by the scheduler thread and callers.

    Percentiles are computed over a bounded window of the most recent
    ``window`` latencies / flushes (a long-lived service must not grow
    memory with uptime); totals (query/flush/dispatch counts, busy time)
    are running sums over the whole lifetime.
    """

    def __init__(self, window: int = 65_536) -> None:
        self._lock = threading.Lock()
        self._latencies: Deque[float] = deque(maxlen=window)
        self._flushes: Deque[FlushRecord] = deque(maxlen=max(1, window // 16))
        self._rejected = 0
        # lifetime totals (windows above are for percentiles/recent stats)
        self._n_queries = 0
        self._n_flushes = 0
        self._busy_s = 0.0
        self._knn = 0
        self._merge = 0
        self._size_sum = 0
        self._max_depth = 0
        self._peak_candidate_bytes = 0
        self._lut_bytes = 0
        # self-healing accounting (``repro_torch.fault``): contained flush crashes,
        # queries failed by deadline expiry, overload-degraded flushes and
        # mode transitions, background-loop errors survived
        self._flush_failures = 0
        self._failed_queries = 0
        self._deadline_expired = 0
        self._degraded_flushes = 0
        self._degraded_transitions = 0
        self._loop_errors = 0
        self._index_swaps = 0

    # ------------------------------------------------------------- recording

    def record_flush(
        self,
        *,
        size: int,
        queue_depth: int,
        knn_dispatches: int,
        merge_dispatches: int,
        seconds: float,
        latencies: Sequence[float],
        peak_candidate_bytes: int = 0,
        lut_bytes: int = 0,
    ) -> None:
        with self._lock:
            self._flushes.append(
                FlushRecord(
                    size, queue_depth, knn_dispatches, merge_dispatches, seconds,
                    peak_candidate_bytes, lut_bytes,
                )
            )
            self._latencies.extend(float(x) for x in latencies)
            self._n_queries += len(latencies)
            self._n_flushes += 1
            self._busy_s += seconds
            self._knn += knn_dispatches
            self._merge += merge_dispatches
            self._size_sum += size
            self._max_depth = max(self._max_depth, queue_depth)
            self._peak_candidate_bytes = max(
                self._peak_candidate_bytes, int(peak_candidate_bytes)
            )
            self._lut_bytes += int(lut_bytes)

    def record_rejected(self) -> None:
        with self._lock:
            self._rejected += 1

    def record_flush_failure(self, n_queries: int) -> None:
        """One flush pipeline crash contained; its queries failed typed."""
        with self._lock:
            self._flush_failures += 1
            self._failed_queries += int(n_queries)

    def record_deadline_expired(self, n_queries: int = 1) -> None:
        with self._lock:
            self._deadline_expired += int(n_queries)

    def record_degraded_flush(self) -> None:
        with self._lock:
            self._degraded_flushes += 1

    def record_degraded_transition(self) -> None:
        """Overload mode flipped (either direction — count both edges)."""
        with self._lock:
            self._degraded_transitions += 1

    def record_loop_error(self) -> None:
        """Background scheduler loop survived a tick exception."""
        with self._lock:
            self._loop_errors += 1

    def record_swap(self) -> None:
        """One completed blue/green index swap (HQIService.swap_index)."""
        with self._lock:
            self._index_swaps += 1

    # --------------------------------------------------------------- reading

    def recent_flushes(self, n: int = 32) -> List[Dict[str, float]]:
        """The most recent flush records as dicts (oldest first) — the
        flight recorder snapshots these into incident bundles."""
        with self._lock:
            tail = list(self._flushes)[-int(n):]
        return [dataclasses.asdict(r) for r in tail]

    @staticmethod
    def _rank(lats, q: float) -> float:
        # nearest-rank percentile over a SORTED list: no numpy dependency
        # needed host-side, and p99 of small samples stays an observed value
        # rather than an interpolation between two
        rank = min(len(lats) - 1, max(0, int(round(q / 100.0 * (len(lats) - 1)))))
        return lats[rank]

    def latency_percentile(self, q: float) -> float:
        """Latency percentile in seconds; q in [0, 100]. 0.0 when empty."""
        with self._lock:
            lats = list(self._latencies)
        if not lats:
            return 0.0
        lats.sort()
        return self._rank(lats, q)

    def summary(self) -> Dict[str, float]:
        # one lock acquisition, one deque copy, one sort — p50 and p99 read
        # the same sorted window instead of each re-copying and re-sorting it
        with self._lock:
            n_q, n_f = self._n_queries, self._n_flushes
            lats = list(self._latencies)
            out: Dict[str, float] = {
                "queries": float(n_q),
                "flushes": float(n_f),
                "rejected": float(self._rejected),
                "mean_flush_size": (self._size_sum / n_f) if n_f else 0.0,
                "max_queue_depth": float(self._max_depth),
                "knn_dispatches_per_flush": (self._knn / n_f) if n_f else 0.0,
                "merge_dispatches_per_flush": (self._merge / n_f) if n_f else 0.0,
                "busy_qps": (n_q / self._busy_s) if self._busy_s > 0 else 0.0,
                "peak_candidate_bytes": float(self._peak_candidate_bytes),
                "lut_bytes_per_flush": (self._lut_bytes / n_f) if n_f else 0.0,
                "flush_failures": float(self._flush_failures),
                "failed_queries": float(self._failed_queries),
                "deadline_expired": float(self._deadline_expired),
                "degraded_flushes": float(self._degraded_flushes),
                "degraded_transitions": float(self._degraded_transitions),
                "loop_errors": float(self._loop_errors),
                "index_swaps": float(self._index_swaps),
            }
        lats.sort()
        out["p50_latency_s"] = self._rank(lats, 50.0) if lats else 0.0
        out["p99_latency_s"] = self._rank(lats, 99.0) if lats else 0.0
        return out
