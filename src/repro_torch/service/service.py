"""HQIService — the online serving facade over the plan/execute engine.

Data plane, per flush (see scheduler.py for when a flush fires):

    submit() ─┐
    submit() ─┼─▶ MicroBatchScheduler ──▶ synthetic Workload
    submit() ─┘                               │
                              HQIIndex.search(batch_vec=cfg.batch_vec,
                                              live_mask=tombstones)
                                               │
                    DeltaStore.scan (live inserts, one fused dispatch)
                                               │
                      kernels.ops.merge_topk (on the index's device) ──▶ QueryHandle

Control plane: ``insert``/``delete`` are visible to the very next flush
(delta scan + tombstone mask); ``refresh()`` folds the delta into the main
index partitions (``HQIIndex.extend``) and invalidates the Router bitmap
cache and arena — never a full rebuild. Admission control bounds the pending
queue; ``submit`` raises ``QueueFull`` beyond ``ServiceConfig.queue_bound``.

The service can be driven synchronously (``tick``/``drain`` — what the
benchmarks and tests do) or by a background thread (``start``/``stop``) with
callers blocking on ``QueryHandle.wait()``; kernel-dispatch accounting stays
correct either way because ``DispatchStats`` is lock-protected.

Flushes are lock-free for writers: ``_flush`` snapshots (batch, live mask,
delta view) under the state lock, dispatches the kernel pipeline outside it,
and re-acquires only to fulfill handles — ``submit``/``insert``/``delete``
during a slow flush queue into the next micro-batch instead of blocking
(tests/test_torch_service.py has the threaded regression). Every device
operand (the engine's, the delta store's, the final merge's) lives on the
index's device: "cuda" for an index built or loaded there, the CPU (plain
versions of the kernels) for one loaded with ``device="cpu"``.

Durability (``repro_torch.store``): with a ``WriteAheadLog`` attached
(``wal=``, wired by ``store.recovery.open_service``/``init_store``), every
``insert``/``delete`` commits a WAL record *before* acknowledging,
``refresh()`` seals the current WAL segment at the fold boundary, and
``store.compact.Compactor`` periodically folds + snapshots so restart cost
stays a snapshot load plus the WAL tail. Without a WAL the service is purely
in-memory.

Self-healing (``repro_torch.fault``): a flush-pipeline crash is contained
per flush — that batch's handles fail with a structured ``QueryError`` and
subsequent flushes keep serving (no stranded ``QueryHandle``, no dead
scheduler thread). Per-query deadlines (``query_deadline_s`` /
``submit(deadline_s=)``) are enforced at admission and at fulfill, failing
expired queries with ``DeadlineExceeded`` instead of spending kernel time on
answers nobody is waiting for. A poisoned WAL or a diverged delta apply
quarantines the WRITE path (``ServiceReadOnly``, fail-fast) while reads keep
serving. Under overload (queue depth or flush latency past the configured
thresholds) the service sheds exactness for liveness — flushes degrade to
``scan_mode="pq"`` at ``degraded_refine_factor`` when the index carries a
codebook — and recovers automatically once pressure drops; degraded answers
are flagged on their handles and surfaced in telemetry. ``health()`` is the
structured ok/degraded/read-only status the future router tier consumes.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Iterable, Optional, Tuple, Union

import numpy as np
import torch

from ..core.hqi import HQIIndex
from ..core.ivf import ScanStats
from ..core.types import SETCAT, VectorDatabase, Workload
from ..fault.failpoints import failpoint
from ..kernels import ops as kops
from ..obs.drift import DriftConfig, DriftMonitor, DriftReport
from ..obs.metrics import get_registry
from ..obs.trace import fence, get_tracer, set_thread_name
from .delta import DeltaStore
from .errors import (  # noqa: F401 — QueueFull re-exported for compatibility
    DeadlineExceeded,
    QueryError,
    QueueFull,
    ResultPending,
    ServiceReadOnly,
)
from .scheduler import MicroBatchScheduler, PendingQuery
from .telemetry import ServiceTelemetry


@dataclasses.dataclass
class ServiceConfig:
    k: int = 10
    nprobe: Union[int, Dict[int, int]] = 8
    # the §6.5 adaptive executor. On an index on the card "auto" means True:
    # every (template × partition) group goes through the engine's kernels
    # rather than a host scan of the arena's copy
    batch_vec: Union[bool, str] = "auto"
    max_batch: int = 256  # size flush trigger
    deadline_s: float = 0.005  # latency flush trigger (oldest query's wait)
    queue_bound: int = 8192  # admission control: max pending queries
    pad_pow2: bool = False  # pad flushes to power-of-two batch slots
    # delta-store compression: once the live delta buffer exceeds this many
    # rows (and the index has a PQ codebook), flush scans encode the delta
    # through the ADC path with exact f32 re-rank of the survivors instead
    # of brute-forcing f32 rows; None disables. Buffers at or under the
    # threshold always scan exact.
    delta_pq_threshold: Optional[int] = 4096
    # workload-drift monitor (obs.drift): sliding window of answered-query
    # templates and reservoir size for the live recall probe
    drift_window: int = 4096
    recall_reservoir: int = 64
    # per-query serving deadline (seconds from submit; None = no deadline).
    # Overridable per call via submit(deadline_s=); enforced at admission
    # (an already-lapsed deadline is rejected) and at flush/fulfill (expired
    # queries fail with DeadlineExceeded instead of burning kernel time)
    query_deadline_s: Optional[float] = None
    # overload degradation: when the post-take queue depth or the flush wall
    # time crosses a threshold, flushes shed to scan_mode="pq" at
    # degraded_refine_factor (needs an index codebook — HQIIndex.attach_pq);
    # recovery is automatic once BOTH pressures drop below threshold ×
    # overload_recover_frac (hysteresis, so the mode doesn't flap)
    overload_queue_depth: Optional[int] = None
    overload_flush_s: Optional[float] = None
    degraded_refine_factor: int = 1
    overload_recover_frac: float = 0.5


@dataclasses.dataclass
class QueryHandle:
    """Caller-side future for one submitted query.

    Every handle *terminates*: fulfilled with (ids, scores), or failed with a
    typed error — ``QueryError`` (the carrying flush crashed; contained) or
    ``DeadlineExceeded`` (the per-query deadline lapsed). ``degraded`` marks
    answers produced by an overload-shed (PQ-approximate) flush, so callers
    comparing against exact references know to exclude them.
    """

    qid: int
    t_submit: float
    ids: Optional[np.ndarray] = None  # i64 [k] once done (-1 padding)
    scores: Optional[np.ndarray] = None  # f32 [k] best-first
    t_done: float = 0.0
    error: Optional[BaseException] = None
    degraded: bool = False
    _event: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False, compare=False
    )

    @property
    def done(self) -> bool:
        """Terminated — fulfilled OR failed. Check ``ok`` to distinguish."""
        return self._event.is_set()

    @property
    def ok(self) -> bool:
        return self._event.is_set() and self.error is None

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

    def result(
        self, timeout: Optional[float] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(ids, scores) of a fulfilled query.

        ``timeout=None`` is the non-blocking accessor: raises ``ResultPending``
        if the query has not terminated yet. With a ``timeout``, blocks up to
        that many seconds and raises ``DeadlineExceeded`` on expiry. A handle
        that terminated in failure re-raises its stored typed error
        (``QueryError`` / ``DeadlineExceeded``).
        """
        if not self._event.is_set():
            if timeout is None:
                raise ResultPending(f"query {self.qid} not answered yet")
            if not self._event.wait(timeout):
                raise DeadlineExceeded(
                    f"result() timed out after {timeout}s for query {self.qid}",
                    qid=self.qid,
                )
        if self.error is not None:
            raise self.error
        return self.ids, self.scores

    @property
    def latency_s(self) -> float:
        return (self.t_done - self.t_submit) if self.done else float("nan")

    def _fulfill(
        self,
        ids: np.ndarray,
        scores: np.ndarray,
        t_done: float,
        degraded: bool = False,
    ) -> None:
        self.ids = ids
        self.scores = scores
        self.t_done = t_done
        self.degraded = degraded
        self._event.set()

    def _fail(self, error: BaseException, t_done: float) -> None:
        self.error = error
        self.t_done = t_done
        self._event.set()


@dataclasses.dataclass
class ServiceHealth:
    """Structured serving status — what ``HQIService.health()`` returns and
    what the metrics registry's ``health`` source publishes.

    ``status`` is the one-word rollup a router shards traffic on:
    ``"ok"`` (full exact serving), ``"degraded"`` (answering, but overload-shed
    to approximate scans), ``"read-only"`` (write path quarantined — poisoned
    WAL or diverged apply — reads still serving).
    """

    status: str
    queue_depth: int
    degraded: bool
    read_only: bool
    write_error: Optional[str]
    wal_synced_seq: Optional[int]
    applied_seq: int
    last_flush_age_s: Optional[float]
    last_flush_s: float
    flush_failures: int
    deadline_expired: int
    compactor_failures: int
    compactor_error: Optional[str]
    armed_failpoints: Tuple[str, ...] = ()
    # index-evolution (tuner) status — defaulted so older callers that build
    # ServiceHealth positionally keep working
    index_swaps: int = 0
    tuner_failures: int = 0
    tuner_error: Optional[str] = None

    def as_dict(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        d["armed_failpoints"] = list(self.armed_failpoints)
        return d


class HQIService:
    """Streaming HVQ service: micro-batched reads, immediately-visible writes."""

    def __init__(
        self,
        index: HQIIndex,
        cfg: Optional[ServiceConfig] = None,
        wal=None,  # store.wal.WriteAheadLog; None = in-memory only
    ) -> None:
        self.index = index
        self.cfg = ServiceConfig() if cfg is None else cfg
        if self.cfg.batch_vec == "auto" and index.device.type == "cuda":
            self.cfg = dataclasses.replace(self.cfg, batch_vec=True)
        self.wal = wal
        # last WAL record whose effects live in (index, _live) rather than
        # the delta buffer — what a snapshot of this service covers
        # (store.compact reads it; store.recovery seeds it after a replay)
        self._wal_folded_seq = 0 if wal is None else wal.last_seq
        # group commit bookkeeping: writers stage their WAL record under the
        # state lock (fixing seq order = id order), share one fsync outside
        # it, then apply in ticket order — _applied_seq is the highest seq
        # whose effects are actually in (delta, _live), which is what a fold
        # may claim as covered (wal.last_seq could include records a
        # concurrent writer has staged but not yet applied)
        self._commit_head = 0
        self._commit_tail = 0
        self._applied_seq = 0 if wal is None else wal.last_seq
        self.scheduler = MicroBatchScheduler(
            max_batch=self.cfg.max_batch,
            deadline_s=self.cfg.deadline_s,
            pad_pow2=self.cfg.pad_pow2,
        )
        # hand the delta the codebook only when compressed delta scans can
        # actually fire — otherwise inserts would pay encode_pq for codes
        # the scan path never reads
        self.delta = DeltaStore(
            index.db,
            first_id=index.db.n,
            pq=index.pq if self.cfg.delta_pq_threshold is not None else None,
            device=index.device,
        )
        self.telemetry = ServiceTelemetry()
        # workload observer feeding the future hot-swap tuner; fed by _flush,
        # read via drift_report()
        self.drift = DriftMonitor(
            DriftConfig(
                window=self.cfg.drift_window, reservoir=self.cfg.recall_reservoir
            )
        )
        # fold this service's telemetry into the process metrics registry
        # (latest service wins the "service" slot — one serving process is
        # the deployment unit)
        get_registry().attach_source("service", self.telemetry.summary)
        get_registry().attach_source("health", lambda: self.health().as_dict())
        self._live = np.ones(index.db.n, dtype=bool)  # tombstones over indexed rows
        # self-healing state (repro_torch.fault). _write_poisoned: a delta apply
        # diverged from what the WAL logged — permanent in-process write
        # quarantine (restart + replay heals it). _degraded: overload shed to
        # approximate scans. _last_flush_* feed the overload detector + health
        self._write_poisoned: Optional[BaseException] = None
        self._degraded = False
        self._last_flush_s = 0.0
        self._last_flush_done: Optional[float] = None
        self._compactor = None  # back-ref set by store.compact.Compactor
        self._tuner = None  # back-ref set by tuner.Tuner (health/metrics)
        self._swaps = 0  # completed blue/green index swaps (swap_index)
        # per-FILTER nprobe overrides installed by the tuner; translated to
        # per-template dicts flush-locally in _answer (template indices are
        # interned per batch, so an index-keyed dict can't persist)
        self._nprobe_by_filter: Optional[Dict[tuple, int]] = None
        # state lock for scheduler + delta + live-mask: writers and the flush
        # snapshot take it BRIEFLY — kernel dispatch happens outside it, so
        # submit()/insert()/delete() never block for a flush's duration
        self._lock = threading.RLock()
        # writers park here until their commit ticket comes up (group commit)
        self._commit_cv = threading.Condition(self._lock)
        # flush lock serializes the out-of-lock pipeline sections: flushes
        # against each other (single logical consumer) and against refresh(),
        # which swaps index structures the in-flight search reads
        self._flush_lock = threading.Lock()
        self._next_qid = 0
        self._thread: Optional[threading.Thread] = None
        self._stop_flag = threading.Event()

    # ------------------------------------------------------------ data plane

    def submit(
        self,
        vector: np.ndarray,
        filt: tuple = (),
        *,
        deadline_s: Optional[float] = None,
    ) -> QueryHandle:
        """Enqueue one hybrid query; answered at the next flush (tick/run).

        ``deadline_s`` (or ``ServiceConfig.query_deadline_s`` when omitted)
        bounds submit→answer: an already-lapsed deadline is rejected here
        (``DeadlineExceeded`` — admission control, nothing queued), and a
        query whose deadline expires before its flush fulfills it is failed
        with ``DeadlineExceeded`` on its handle instead of consuming kernel
        time.
        """
        now = time.perf_counter()
        dl = self.cfg.query_deadline_s if deadline_s is None else deadline_s
        if dl is not None and dl <= 0:
            self.telemetry.record_deadline_expired()
            raise DeadlineExceeded(f"deadline {dl}s lapsed at admission", qid=-1)
        with self._lock:
            if len(self.scheduler) >= self.cfg.queue_bound:
                self.telemetry.record_rejected()
                raise QueueFull(f"pending queue at bound {self.cfg.queue_bound}")
            h = QueryHandle(qid=self._next_qid, t_submit=now)
            self._next_qid += 1
            self.scheduler.push(
                PendingQuery(
                    handle=h,
                    vector=np.asarray(vector, dtype=np.float32),
                    filt=filt,
                    t_submit=now,
                    t_deadline=None if dl is None else now + dl,
                )
            )
        tracer = get_tracer()
        if tracer.enabled:  # hottest path: skip even the no-op kwargs build
            tracer.instant("submit", qid=h.qid)
        return h

    def insert(
        self,
        vectors: np.ndarray,
        columns: Optional[Dict[str, np.ndarray]] = None,
        null_masks: Optional[Dict[str, np.ndarray]] = None,
    ) -> np.ndarray:
        """Add tuples to the live DB; visible to the next flush. Returns ids.

        With a WAL attached the insert is committed durably BEFORE the ids
        are returned — an acknowledged insert survives a crash (recovery
        replays the WAL tail into a fresh delta store, same ids). Ordering:
        validate → WAL stage → group fsync → apply, so a rejected insert is
        never logged and a failed stage never leaves unlogged rows visible.
        Concurrent writers share one fsync (WAL group commit): each stages
        its record under the state lock — fixing seq order = id order, the
        invariant recovery's replay asserts — then blocks on
        ``wal.sync_upto`` outside it, and applies in ticket (= seq) order.
        """
        with get_tracer().span("service.insert"):
            self._check_writable()
            if self.wal is None:
                with self._lock:
                    slab, ids = self.delta.prepare_insert(vectors, columns, null_masks)
                    try:
                        self.delta.commit_insert(slab, ids)
                    except BaseException:
                        # nothing logged, nothing applied — release the id
                        # reservation so the next insert gets these ids
                        self.delta.abort_insert(ids)
                        raise
                return ids
            with self._lock:
                slab, ids = self.delta.prepare_insert(vectors, columns, null_masks)
                try:
                    seq = self.wal.stage_insert(slab.vectors, ids, columns, null_masks)
                except BaseException:
                    # the frame never reached the log; releasing the
                    # reservation is safe because prepare+stage share this
                    # critical section — no later writer saw these ids
                    self.delta.abort_insert(ids)
                    raise
                ticket = self._commit_tail
                self._commit_tail += 1
            try:
                self.wal.sync_upto(seq)
            finally:
                # apply even when the fsync failed: the frame is in the log (a
                # replay would re-apply it) and later tickets' id-ordered
                # commits depend on this slab's rows being in place; the
                # caller still sees the durability error because the
                # exception propagates
                self._commit_in_order(
                    ticket, seq, lambda: self.delta.commit_insert(slab, ids)
                )
            return ids

    def delete(self, ids: Iterable[int]) -> int:
        """Tombstone tuples by global id; visible to the next flush.

        With a WAL attached the delete is committed durably BEFORE it is
        acknowledged and before any tombstone is applied (same contract as
        ``insert``; replay is idempotent). Deletes join the same group-commit
        ticket queue as inserts, so tombstones apply in WAL seq order — the
        order a recovery replay reproduces.
        """
        ids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
        with get_tracer().span("service.delete"):
            self._check_writable()
            if self.wal is None:
                with self._lock:
                    return self._delete_locked(ids)
            with self._lock:
                seq = self.wal.stage_delete(ids)
                ticket = self._commit_tail
                self._commit_tail += 1
            try:
                self.wal.sync_upto(seq)
            finally:
                n = self._commit_in_order(
                    ticket, seq, lambda: self._delete_locked(ids)
                )
            return n

    def _commit_in_order(self, ticket: int, seq: int, apply_fn):
        """Run a staged write's apply step when its ticket comes up.

        Tickets are taken in the same critical section that staged the WAL
        record, so ticket order == seq order — applying in ticket order keeps
        the live state's mutation order identical to what a replay of the log
        would produce (and keeps ``commit_insert``'s id-order contract).
        """
        with self._commit_cv:
            while self._commit_head != ticket:
                self._commit_cv.wait()
            try:
                out = apply_fn()
            except BaseException as e:
                # the record IS in the log but its effect is NOT in the live
                # state — and the ids it reserved cannot be released (a replay
                # would reproduce them). In-memory writes can never be
                # reconciled with the log again: quarantine the write path
                # (reads keep serving; restart + WAL replay heals). Crucially
                # _applied_seq must NOT advance past this record — a fold
                # claiming it as covered would drop it from recovery
                self._write_poisoned = e
                raise
            else:
                self._applied_seq = max(self._applied_seq, seq)
                return out
            finally:
                self._commit_head += 1
                self._commit_cv.notify_all()

    def _delete_locked(self, ids: Iterable[int]) -> int:
        """Apply tombstones without WAL commit (shared with WAL replay)."""
        n = 0
        for ext_id in np.atleast_1d(np.asarray(ids, dtype=np.int64)):
            ext_id = int(ext_id)
            if 0 <= ext_id < len(self._live):
                if self._live[ext_id]:
                    self._live[ext_id] = False
                    n += 1
            elif self.delta.delete(ext_id):
                n += 1
        return n

    def _check_writable(self) -> None:
        """Fail-fast gate on the write path (reads never come through here).

        Two quarantine flavors: a poisoned WAL (durability I/O failed past
        its retry budget — ``clear_poison()`` after fixing the disk heals it)
        and a diverged delta apply (in-process state can no longer be
        reconciled with the log — only restart + replay heals).
        """
        if self._write_poisoned is not None:
            raise ServiceReadOnly(
                "write path quarantined: delta apply diverged from WAL",
                cause=self._write_poisoned,
            )
        if self.wal is not None and getattr(self.wal, "poisoned", None) is not None:
            raise ServiceReadOnly(
                "write path quarantined: WAL poisoned", cause=self.wal.poisoned
            )

    def health(self) -> ServiceHealth:
        """Structured ok/degraded/read-only serving status (see ServiceHealth)."""
        from ..fault import failpoints as _fp

        with self._lock:
            depth = len(self.scheduler)
            degraded = self._degraded
            apply_poison = self._write_poisoned
            applied_seq = self._applied_seq
            last_done = self._last_flush_done
            last_s = self._last_flush_s
            swaps = self._swaps
        wal_poison = (
            getattr(self.wal, "poisoned", None) if self.wal is not None else None
        )
        write_error = apply_poison if apply_poison is not None else wal_poison
        read_only = write_error is not None
        comp = self._compactor
        tun = self._tuner
        tsum = self.telemetry.summary()
        return ServiceHealth(
            status=("read-only" if read_only else "degraded" if degraded else "ok"),
            queue_depth=depth,
            degraded=degraded,
            read_only=read_only,
            write_error=None if write_error is None else repr(write_error),
            wal_synced_seq=None if self.wal is None else self.wal.synced_seq,
            applied_seq=applied_seq,
            last_flush_age_s=(
                None if last_done is None else time.perf_counter() - last_done
            ),
            last_flush_s=last_s,
            flush_failures=int(tsum["flush_failures"]),
            deadline_expired=int(tsum["deadline_expired"]),
            compactor_failures=(
                0 if comp is None else int(comp.consecutive_failures)
            ),
            compactor_error=(
                None
                if comp is None or comp.last_error is None
                else repr(comp.last_error)
            ),
            armed_failpoints=tuple(sorted(_fp.list_armed())),
            index_swaps=swaps,
            tuner_failures=(0 if tun is None else int(tun.consecutive_failures)),
            tuner_error=(
                None
                if tun is None or tun.last_error is None
                else repr(tun.last_error)
            ),
        )

    @property
    def n_live(self) -> int:
        with self._lock:
            return int(self._live.sum()) + self.delta.n_live

    def live_ids(self) -> np.ndarray:
        """Global ids of all live tuples (indexed + delta), ascending."""
        with self._lock:
            base = np.nonzero(self._live)[0].astype(np.int64)
            _, delta_live = self.delta.snapshot()
            extra = self.delta.first_id + np.nonzero(delta_live)[0].astype(np.int64)
        return np.concatenate([base, extra])

    # --------------------------------------------------------------- refresh

    def refresh(self) -> int:
        """Fold the delta buffer into the main index partitions.

        Incremental: qd-tree leaf routing for the new rows, per-partition
        IVF append, arena update reusing unchanged partitions — no
        Algorithm-1/k-means re-run. Invalidates the Router bitmap cache
        (bitmaps are [db.n] and the DB grew). Tombstoned delta rows fold in
        as dead rows so global ids stay dense. Returns #rows folded.

        Takes the flush lock first (same order as ``_flush``): the fold
        mutates index structures an in-flight flush would be reading outside
        the state lock.

        With a WAL attached, a fold also seals the current WAL segment
        (``rotate``) — folded records are covered by the next snapshot, so
        compaction can prune whole sealed segments.
        """
        with self._flush_lock, get_tracer().span("service.refresh"):
            return self._refresh_locked()

    def _refresh_locked(self) -> int:
        """The fold body; caller holds the flush lock (see ``Compactor``)."""
        with self._lock:
            delta_db, delta_live = self.delta.snapshot()
            n = 0
            if delta_db is not None:
                self.index.extend(delta_db)
                self._live = np.concatenate([self._live, delta_live])
                self.delta.clear(first_id=self.index.db.n)
                n = delta_db.n
            if self.wal is not None:
                # with the delta (now) empty, EVERY applied record's effect
                # lives in (index, _live): inserts were just folded, deletes
                # tombstoned _live at commit time — so a delete-only interval
                # also advances the folded seq and seals its segment (or the
                # WAL could never be pruned under delete-heavy traffic).
                # _applied_seq, not wal.last_seq: a concurrent group-commit
                # writer may have STAGED a record it hasn't applied yet, and
                # claiming that seq as folded would drop it from recovery
                self._wal_folded_seq = self._applied_seq
                self.wal.rotate()
            return n

    # ------------------------------------------------------------- hot swap

    def set_nprobe_by_filter(self, mapping: Optional[Dict[tuple, int]]) -> None:
        """Install (or clear, with None) per-FILTER nprobe overrides.

        ``ServiceConfig.nprobe`` dicts are keyed by template *index*, which
        is flush-local (the scheduler interns templates per micro-batch), so
        a tuner's per-template tuning can't persist in that form. The tuner
        hands over a dict keyed by the filter tuples themselves; ``_answer``
        translates it per flush. Filters the tuning never saw fall back to
        the config default.
        """
        with self._lock:
            self._nprobe_by_filter = None if mapping is None else dict(mapping)

    def swap_index(
        self, index: HQIIndex, live: np.ndarray, covered_seq: int
    ) -> Tuple[HQIIndex, np.ndarray, int, int]:
        """Blue/green swap: replace the serving index with one built off to
        the side, losing no acknowledged write and dropping no query.

        ``index``/``live`` must cover the SAME global-id prefix the serving
        state had at capture time — ids are row positions, so the new index
        is built over the full captured DB, dead rows included, and nothing
        renumbers — and ``covered_seq`` is the highest WAL seq whose effect
        the build includes. The tail (writes acknowledged after capture) is
        re-established on the new index before it serves: replayed from the
        WAL past ``covered_seq`` when one is attached, else adopted from the
        displaced in-memory view (id-ordered, so the rows past the new
        index's count are exactly the post-capture inserts).

        Fault containment: the ``tuner.swap`` failpoint, the group-commit
        drain, and the tail replay all happen BEFORE any serving state is
        touched — a swap that faults anywhere leaves the old index serving
        untouched. In-flight flushes finished under the flush lock we hold;
        queued queries simply answer on the new index at their next flush.

        Returns ``(old_index, old_live, old_covered_seq, n_tail_replayed)``
        — the first three are exactly the arguments a later ``swap_index``
        call needs for instant rollback.
        """
        with self._flush_lock, get_tracer().span("service.swap"):
            failpoint("tuner.swap")
            with self._commit_cv:
                # Drain the group-commit pipeline: a writer that staged its
                # WAL record but hasn't applied yet would otherwise apply
                # into the delta we're about to retire — and the replay
                # below reads the WAL file, which already holds its frame,
                # so the write would land twice.
                while self._commit_head != self._commit_tail:
                    self._commit_cv.wait()
                new_live = np.array(live, dtype=bool, copy=True)
                delta = DeltaStore(
                    index.db,
                    first_id=index.db.n,
                    pq=(
                        index.pq
                        if self.cfg.delta_pq_threshold is not None
                        else None
                    ),
                    device=index.device,
                )
                if self.wal is not None:
                    replayed = self._replay_tail(delta, new_live, covered_seq)
                else:
                    replayed = self._adopt_tail(delta, new_live)
                # ---- point of no return: mutate serving state atomically
                old_index, old_live = self.index, self._live
                old_seq = self._wal_folded_seq
                self.index = index
                self._live = new_live
                self.delta = delta
                if self.wal is not None:
                    self._wal_folded_seq = covered_seq
                # stale router bitmaps / arena views from a previous serving
                # stint (rollback) must not survive the swap; a fresh build
                # just rebuilds lazily on first flush
                self.index.invalidate_caches()
                self._swaps += 1
            self.telemetry.record_swap()
            get_registry().counter("service.index_swaps").inc(1)
            # retained drift traffic describes the displaced layout — a
            # share-shift computed across the swap boundary would immediately
            # re-trigger the tuner on its own rebuild
            self.drift.reset()
        return old_index, old_live, old_seq, replayed

    def _replay_tail(
        self, delta: DeltaStore, live: np.ndarray, after_seq: int
    ) -> int:
        """Replay acked WAL records past ``after_seq`` into a swap-candidate
        (delta, live) pair; returns #records. Caller holds both locks with
        the commit pipeline drained, so the log holds no staged-but-unapplied
        frame. Same transitions as recovery's ``replay_into``, including the
        id-continuity check: the first replayed insert must land exactly at
        the new index's row count, or the build captured a different id
        space than the log describes."""
        # lazy: the store imports this module
        from ..store.recovery import RecoveryError
        from ..store.wal import KIND_DELETE, KIND_INSERT, split_insert_arrays

        n = 0
        for rec in self.wal.replay(after_seq):
            if rec.kind == KIND_INSERT:
                vectors, ids, columns, null_masks = split_insert_arrays(
                    rec.arrays
                )
                got = delta.insert(vectors, columns or None, null_masks or None)
                if not np.array_equal(got, ids):
                    raise RecoveryError(
                        f"swap replay diverged at WAL record {rec.seq}: "
                        f"ids {got.tolist()} != committed {ids.tolist()}"
                    )
            elif rec.kind == KIND_DELETE:
                for ext_id in np.atleast_1d(
                    np.asarray(rec.arrays["ids"], dtype=np.int64)
                ):
                    ext_id = int(ext_id)
                    if 0 <= ext_id < len(live):
                        live[ext_id] = False
                    else:
                        delta.delete(ext_id)
            else:
                raise RecoveryError(
                    f"swap replay: WAL record {rec.seq} has unknown kind "
                    f"{rec.kind}"
                )
            n += 1
        return n

    def _adopt_tail(self, delta: DeltaStore, live: np.ndarray) -> int:
        """No-WAL swap tail: carry post-capture writes from the serving
        in-memory view into a swap candidate; returns #rows adopted.

        The full view (indexed rows + delta rows) is id-ordered, so rows at
        positions >= the new index's row count are exactly the inserts the
        build didn't capture; post-capture deletes are wherever the serving
        masks went dead."""
        cut = delta.first_id  # == the new index's db.n
        cur_db, cur_live = self.delta.snapshot()
        full_db = (
            self.index.db
            if cur_db is None
            else VectorDatabase.concat(self.index.db, cur_db)
        )
        full_live = np.concatenate([self._live, cur_live])
        # deletes over rows the new index holds fold into its live mask
        m = min(len(live), len(full_live))
        np.logical_and(live[:m], full_live[:m], out=live[:m])
        if full_db.n <= cut:
            return 0
        tail = full_db.take(np.arange(cut, full_db.n))
        cols: Dict[str, np.ndarray] = {}
        nms: Dict[str, np.ndarray] = {}
        for name, c in tail.columns.items():
            cols[name] = c.values
            if c.kind != SETCAT and c.null_mask is not None:
                nms[name] = c.null_mask
        got = delta.insert(tail.vectors, cols or None, nms or None)
        assert int(got[0]) == cut, "adopted tail broke id continuity"
        for gid in cut + np.nonzero(~full_live[cut:])[0]:
            delta.delete(int(gid))
        return int(full_db.n - cut)

    # ---------------------------------------------------------- serving loop

    def tick(self, now: Optional[float] = None) -> int:
        """Flush once if a trigger fired; returns #queries terminated."""
        failpoint("scheduler.tick")
        with self._lock:
            if not self.scheduler.ready(now):
                return 0
        return self._flush(ready_only=True, now=now)

    def flush(self) -> int:
        """Force a flush of whatever is pending (ignores triggers).

        No empty-queue fast path on purpose: ``_flush`` serializes on the
        flush lock, so even a 0 return waits out any in-flight flush —
        keeping ``drain()``'s contract that returning means every previously
        submitted query has been answered, not merely taken.
        """
        return self._flush()

    def drain(self) -> int:
        """Flush until the queue is empty; returns #queries answered."""
        total = 0
        while True:
            n = self.flush()
            if n == 0:
                return total
            total += n

    def _flush(self, ready_only: bool = False, now: Optional[float] = None) -> int:
        """One micro-batch through engine + delta + merge — lock-free pipeline.

        Three phases: (1) snapshot the batch, live mask, and delta view under
        the state lock; (2) dispatch the whole kernel pipeline OUTSIDE it, so
        concurrent ``submit``/``insert``/``delete`` queue into the next
        micro-batch instead of blocking for the flush duration; (3) re-acquire
        to fulfill handles and record telemetry. Flushes serialize among
        themselves (and against ``refresh``) on the flush lock; ``ready_only``
        (the ``tick`` path) re-checks the trigger once inside it, so a caller
        that queued behind another flush doesn't prematurely flush queries
        that arrived meanwhile and are still inside the batching window.
        """
        tracer = get_tracer()
        with self._flush_lock:
            with self._lock:
                if ready_only and not self.scheduler.ready(now):
                    return 0
                batch = self.scheduler.take()
                if not batch:
                    return 0
                depth = len(self.scheduler)
                # deadline gate #1 (take): fail already-expired queries before
                # spending any kernel time on them
                t_take = time.perf_counter()
                alive, expired = [], []
                for pq in batch:
                    dead = pq.t_deadline is not None and t_take >= pq.t_deadline
                    (expired if dead else alive).append(pq)
                for pq in expired:
                    pq.handle._fail(
                        DeadlineExceeded(
                            f"deadline lapsed before flush (query {pq.handle.qid})",
                            qid=pq.handle.qid,
                        ),
                        t_take,
                    )
                if expired:
                    self.telemetry.record_deadline_expired(len(expired))
                batch = alive
                if not batch:
                    return len(expired)
                degraded = self._update_overload(depth)
                wl, n_real = self.scheduler.build_workload(batch, self.cfg.k)
                live = self._live.copy()
                delta_view = self.delta.view()
                delta_rows = self.delta.n
            if tracer.enabled:
                # retroactive per-query queue-wait spans: t_submit and the
                # tracer share the perf_counter clock, so submit→flush waits
                # land exactly on the timeline even though they are only
                # known now
                t_start = time.perf_counter()
                for pq in batch:
                    tracer.add_span(
                        "queue.wait", pq.t_submit, t_start, qid=pq.handle.qid
                    )
                tracer.counter("queue.depth", depth)
            before = kops.dispatch_stats().snapshot()
            t0 = time.perf_counter()
            try:
                with tracer.span("flush", size=n_real, depth=depth):
                    failpoint("service.flush")
                    ids, scores, res = self._answer(
                        wl, live, delta_view, degraded=degraded
                    )
            except Exception as e:
                # crash containment: this flush's queries fail typed, the
                # service keeps serving — no stranded handle, no dead loop
                t_done = time.perf_counter()
                with self._lock:
                    for pq in batch:
                        pq.handle._fail(
                            QueryError(
                                f"flush pipeline failed (query {pq.handle.qid})",
                                qid=pq.handle.qid,
                                cause=e,
                            ),
                            t_done,
                        )
                    self._last_flush_s = t_done - t0
                    self._last_flush_done = t_done
                self.telemetry.record_flush_failure(len(batch))
                get_registry().counter("service.flush_failures").inc(1)
                return n_real + len(expired)
            dt = time.perf_counter() - t0
            delta_stats = kops.dispatch_stats().delta_since(before)
            t_done = time.perf_counter()
            with self._lock:
                lats = []
                n_late = 0
                with tracer.span("flush.fulfill", size=n_real):
                    # deadline gate #2 (fulfill): the answer exists but came
                    # too late — the caller's contract says fail, not a
                    # surprise stale success
                    for i, pq in enumerate(batch):
                        if pq.t_deadline is not None and t_done >= pq.t_deadline:
                            pq.handle._fail(
                                DeadlineExceeded(
                                    f"deadline lapsed during flush "
                                    f"(query {pq.handle.qid})",
                                    qid=pq.handle.qid,
                                ),
                                t_done,
                            )
                            n_late += 1
                        else:
                            pq.handle._fulfill(
                                ids[i], scores[i], t_done, degraded=degraded
                            )
                            lats.append(t_done - pq.t_submit)
                if n_late:
                    self.telemetry.record_deadline_expired(n_late)
                if degraded:
                    self.telemetry.record_degraded_flush()
                self._last_flush_s = dt
                self._last_flush_done = t_done
                self.telemetry.record_flush(
                    size=n_real,
                    queue_depth=depth,
                    knn_dispatches=delta_stats.knn_calls,
                    merge_dispatches=delta_stats.merge_calls,
                    seconds=dt,
                    latencies=lats,
                    peak_candidate_bytes=res.peak_candidate_bytes,
                    lut_bytes=res.lut_bytes,
                )
            self._observe_flush(batch, ids, lats, res, delta_rows)
        return n_real + len(expired)

    def _update_overload(self, depth: int) -> bool:
        """Overload detector (caller holds the state lock): returns whether
        THIS flush should run degraded. Enter on either pressure signal
        (post-take queue depth, last flush wall time) crossing its threshold;
        exit only when both drop below threshold × ``overload_recover_frac``
        (hysteresis). Degrading needs a codebook — an index without ``pq``
        never sheds, whatever the pressure."""
        cfg = self.cfg
        qd, fl = cfg.overload_queue_depth, cfg.overload_flush_s
        if (qd is None and fl is None) or self.index.pq is None:
            return False
        over_q = qd is not None and depth >= qd
        over_f = fl is not None and self._last_flush_s >= fl
        if not self._degraded:
            if over_q or over_f:
                self._degraded = True
                self.telemetry.record_degraded_transition()
        else:
            frac = cfg.overload_recover_frac
            calm_q = qd is None or depth <= qd * frac
            calm_f = fl is None or self._last_flush_s <= fl * frac
            if calm_q and calm_f:
                self._degraded = False
                self.telemetry.record_degraded_transition()
        get_registry().gauge("service.degraded").set(1 if self._degraded else 0)
        return self._degraded

    def _observe_flush(self, batch, ids, lats, res, delta_rows: int) -> None:
        """Feed the metrics registry and drift monitor from one flush (runs
        outside the state lock — every input is a flush-local snapshot)."""
        reg = get_registry()
        qw = reg.histogram("service.queue_wait_s")
        for w in lats:
            qw.observe(w)
        reg.histogram("service.flush_size").observe(len(batch))
        reg.histogram("engine.bytes_scanned").observe(res.bytes_scanned)
        reg.histogram("engine.peak_candidate_bytes").observe(res.peak_candidate_bytes)
        self.drift.observe_queries([pq.filt for pq in batch])
        if res.part_probes:
            self.drift.observe_probes(res.part_probes)
        self.drift.observe_delta(delta_rows)
        for i, pq in enumerate(batch):
            self.drift.maybe_sample(pq.vector, pq.filt, ids[i])

    def drift_report(
        self, *, probe_recall: bool = False, k: Optional[int] = None
    ) -> DriftReport:
        """Current workload-drift reading (see obs.drift). ``probe_recall``
        additionally replays the answered-query reservoir against a
        brute-force scan of the live DB — exact but O(n), so keep it off
        latency-sensitive paths."""
        return self.drift.report(self, probe_recall=probe_recall, k=k)

    def _answer(self, wl: Workload, live: np.ndarray, delta_view, degraded=False):
        """(ids i64 [m, k], scores f32 [m, k], SearchResult): engine + delta.

        Operates on the flush's snapshots (live mask copy, immutable delta
        view) so it can run outside the state lock. The engine's
        ``SearchResult`` rides along for the flush's telemetry (candidate
        buffer peak, LUT bytes). A ``degraded`` flush sheds the main-index
        scan to the ADC path (``scan_mode="pq"`` at ``degraded_refine_factor``)
        — the delta scan stays as configured, since the delta buffer is small
        by construction and never the overload source.
        """
        tracer = get_tracer()
        scan_kw = (
            {"scan_mode": "pq", "refine_factor": self.cfg.degraded_refine_factor}
            if degraded
            else {}
        )
        nprobe: Union[int, Dict[int, int]] = self.cfg.nprobe
        by_filter = self._nprobe_by_filter
        if by_filter is not None:
            # tuner overrides are keyed by filter tuple; template indices are
            # interned per batch, so translate for THIS flush's workload
            default = nprobe if isinstance(nprobe, int) else 8
            nprobe = {
                ti: by_filter.get(filt, default)
                for ti, filt in enumerate(wl.templates)
            }
        with tracer.span("engine.search", m=wl.m):
            res = self.index.search(
                wl,
                nprobe=nprobe,
                batch_vec=self.cfg.batch_vec,
                live_mask=live,
                **scan_kw,
            )
        with tracer.span("delta.scan", rows=len(delta_view.live)):
            delta_out = delta_view.scan(
                wl,
                stats=ScanStats(),
                pq_threshold=self.cfg.delta_pq_threshold,
                refine_factor=self.index.cfg.plan.refine_factor,
            )
        if delta_out is None:
            return res.ids, res.scores, res
        ds, di = delta_out  # on the index's device: only the engine's [m, k] is uploaded
        dev = ds.device
        cat_s = torch.cat([torch.as_tensor(res.scores, dtype=torch.float32, device=dev), ds], dim=1)
        cat_i = torch.cat([torch.as_tensor(res.ids, dtype=torch.int64, device=dev), di], dim=1)
        with tracer.span("delta.merge", m=wl.m):
            ms, mi = kops.merge_topk(cat_s, cat_i, wl.k)
            ms, mi = fence(ms, mi)
        return mi.cpu().numpy().astype(np.int64), ms.cpu().numpy().astype(np.float32), res

    # ------------------------------------------------------- background loop

    def start(self, poll_s: Optional[float] = None) -> None:
        """Run the flush loop on a background scheduler thread."""
        assert self._thread is None, "service already running"
        poll = self.cfg.deadline_s / 4 if poll_s is None else poll_s
        poll = max(1e-4, float(poll))
        self._stop_flag.clear()

        def loop() -> None:
            set_thread_name("service")  # root spans tagged for trace triage
            while not self._stop_flag.is_set():
                try:
                    n = self.tick()
                except Exception:
                    # a tick that dies must not kill the scheduler thread —
                    # _flush already contained per-batch failures; anything
                    # reaching here (e.g. an armed scheduler.tick failpoint)
                    # is counted and survived
                    self.telemetry.record_loop_error()
                    n = 0
                if n == 0:
                    time.sleep(poll)

        self._thread = threading.Thread(target=loop, name="hqi-service", daemon=True)
        self._thread.start()

    def stop(self, drain: bool = True) -> None:
        """Stop the scheduler thread (optionally answering remaining queries)."""
        if self._thread is None:
            return
        self._stop_flag.set()
        self._thread.join()
        self._thread = None
        if drain:
            self.drain()

    # ------------------------------------------------------------ inspection

    def snapshot_db(self) -> VectorDatabase:
        """The live DB as a standalone VectorDatabase (offline-parity tool):
        indexed rows + delta rows, minus tombstones, in global-id order."""
        with self._lock:
            delta_db, _ = self.delta.snapshot()
            full = (
                self.index.db
                if delta_db is None
                else VectorDatabase.concat(self.index.db, delta_db)
            )
            return full.take(self.live_ids())
