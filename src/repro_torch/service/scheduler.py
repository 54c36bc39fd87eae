"""Deadline/size-triggered micro-batch scheduler for online HVQ traffic.

Online queries arrive one at a time; the plan/execute engine is fastest
when handed a whole ``Workload`` at once (one global plan, O(#buckets)
dispatches). The scheduler bridges the two: submitted queries accumulate in
a FIFO and are flushed as one synthetic workload when either trigger fires —

  * **size**: ``max_batch`` queries are waiting (a full batch amortizes the
    plan/dispatch cost best), or
  * **deadline**: the oldest query has waited ``deadline_s`` (bounds p99
    latency under light traffic).

``build_workload`` interns each query's filter into the template list — the
filter-commonality grouping of Algorithm 3 happens here for free, since KG
traffic reuses a few templates — and optionally pads the flush up to the next
power-of-two batch slot (``pad_pow2``), the static-shape discipline of
``serve/server.py``'s slot server: repeated flush shapes repeat the
kernels' launch shapes instead of one shape per batch size. Padding rows
replicate query 0 and are dropped by the service before results are handed
back.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, List, Optional, Tuple

import numpy as np

from ..core.plan import _next_pow2
from ..core.types import HybridQuery, Workload
from ..obs.metrics import get_registry
from ..obs.trace import get_tracer


@dataclasses.dataclass
class PendingQuery:
    """One submitted query waiting for a flush (handle owned by service.py)."""

    handle: object  # service.QueryHandle; opaque here
    vector: np.ndarray  # f32 [d]
    filt: tuple  # canonical filter (see predicates.make_filter)
    t_submit: float
    # absolute perf_counter deadline (service deadline policy); None = none.
    # The service enforces it at flush take and at fulfill — the scheduler
    # itself stays policy-free
    t_deadline: Optional[float] = None


class MicroBatchScheduler:
    """FIFO accumulator with deadline/size flush triggers (single consumer)."""

    def __init__(
        self,
        *,
        max_batch: int = 256,
        deadline_s: float = 0.005,
        pad_pow2: bool = False,
    ) -> None:
        assert max_batch >= 1
        self.max_batch = int(max_batch)
        self.deadline_s = float(deadline_s)
        self.pad_pow2 = bool(pad_pow2)
        self._pending: Deque[PendingQuery] = deque()

    def __len__(self) -> int:
        return len(self._pending)

    def push(self, pq: PendingQuery) -> None:
        self._pending.append(pq)

    def oldest_wait(self, now: Optional[float] = None) -> float:
        """Seconds the head-of-line query has waited; 0 when idle."""
        if not self._pending:
            return 0.0
        now = time.perf_counter() if now is None else now
        return max(0.0, now - self._pending[0].t_submit)

    def ready(self, now: Optional[float] = None) -> bool:
        if not self._pending:
            return False
        if len(self._pending) >= self.max_batch:
            return True
        return self.oldest_wait(now) >= self.deadline_s

    def take(self) -> List[PendingQuery]:
        """Pop the next flush (up to ``max_batch`` queries, FIFO order)."""
        n = min(len(self._pending), self.max_batch)
        batch = [self._pending.popleft() for _ in range(n)]
        get_registry().gauge("service.queue_depth").set(len(self._pending))
        return batch

    def build_workload(self, batch: List[PendingQuery], k: int) -> Tuple[Workload, int]:
        """(synthetic Workload, n_real): flush → engine input.

        Row i of the workload is batch[i]; rows ≥ n_real are padding slots
        (present only with ``pad_pow2``) whose results the service discards.
        """
        assert batch, "empty flush"
        m = len(batch)
        with get_tracer().span("flush.build", size=m):
            wl = Workload.from_queries(
                [HybridQuery(vector=pq.vector, filter=pq.filt) for pq in batch], k=k
            )
        if self.pad_pow2:
            slots = _next_pow2(m, 1)
            if slots > m:
                pad = slots - m
                wl = Workload(
                    vectors=np.concatenate(
                        [wl.vectors, np.repeat(wl.vectors[:1], pad, axis=0)]
                    ),
                    templates=wl.templates,
                    template_of=np.concatenate(
                        [wl.template_of, np.full(pad, wl.template_of[0], dtype=np.int32)]
                    ),
                    k=k,
                )
        return wl, m
