"""Background compaction: fold the delta, snapshot a fresh generation, prune.

Between refreshes the write working set lives in the DeltaStore and the WAL
tail grows per commit; restart cost is snapshot-load + WAL-replay. The
compactor bounds that tail: periodically (or when the delta outgrows
``min_delta_rows``) it

  1. folds the delta into the index partitions via the service's existing
     incremental ``refresh()`` path (qd-tree leaf routing + IVF append +
     ``PackedArena.updated`` — never a rebuild), which also seals the WAL
     segment at the fold boundary;
  2. captures (index state, live mask, folded WAL seq) under the flush lock
     — a consistent point: refresh is excluded, and concurrent writes land
     in the delta + WAL *after* the captured seq, so recovery replays them;
  3. writes a new snapshot generation OUTSIDE the service locks (tmp-dir +
     atomic rename + CURRENT swap, see snapshot.py) — flushes and writes
     proceed while the blobs stream to disk (the arena's device tensors are
     captured as references and copied to the host there, not under the
     lock);
  4. prunes old generations (keeping ``keep_generations``) and deletes WAL
     segments every remaining generation already covers.

Snapshotting at fold points is also what keeps recovery *bit-identical*
under approximate search: every row is either in the snapshot's partitions
or in the replayed delta, exactly as in the uncrashed process.
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional

from ..fault.failpoints import failpoint
from ..obs.metrics import get_registry
from ..obs.trace import get_tracer, set_thread_name
from ..service.service import HQIService
from .snapshot import (
    build_state,
    list_generations,
    prune_generations,
    write_generation,
)
from .wal import WriteAheadLog


class Compactor:
    """Folds + snapshots an ``HQIService`` store in the background.

    Drive it synchronously (``compact_once``) or as a daemon thread
    (``start``/``stop``). One compactor per store root; compaction never
    blocks readers for longer than the in-memory fold (step 2 holds the
    flush lock only to capture array *references* — blob writing happens
    outside).
    """

    def __init__(
        self,
        service: HQIService,
        root: str,
        *,
        interval_s: float = 30.0,
        min_delta_rows: int = 1,
        keep_generations: int = 2,
        max_backoff_s: float = 300.0,
    ) -> None:
        assert service.wal is not None, "compaction needs a WAL-backed service"
        self.service = service
        self.root = root
        self.interval_s = float(interval_s)
        self.min_delta_rows = int(min_delta_rows)
        self.keep_generations = int(keep_generations)
        # failure backoff (fault.retry): after N consecutive failed cycles the
        # background loop waits interval_s · 2^N (capped) before retrying — a
        # persistently failing snapshot disk must not be hammered every tick
        self.max_backoff_s = float(max_backoff_s)
        self.consecutive_failures = 0
        self.generations_written = 0
        # seconds the last cycle held the service's flush lock (fold +
        # capture), and of that the capture alone
        self.last_lock_s = 0.0
        self.last_capture_s = 0.0
        self.last_error: Optional[BaseException] = None  # background health
        self._thread: Optional[threading.Thread] = None
        self._stop_flag = threading.Event()
        # surface compactor health in the process registry (obsdump shows it)
        get_registry().attach_source("compactor", self._metrics)
        # back-ref for HQIService.health()'s compactor fields
        service._compactor = self

    def _metrics(self) -> dict:
        return {
            "generations_written": self.generations_written,
            "consecutive_failures": self.consecutive_failures,
            "last_error": None if self.last_error is None else repr(self.last_error),
            "backoff_s": self._backoff_s(),
        }

    def _backoff_s(self) -> float:
        """Current inter-cycle delay: interval, exponentially inflated by
        consecutive failures, capped at ``max_backoff_s``."""
        if self.consecutive_failures == 0:
            return self.interval_s
        return min(
            self.max_backoff_s,
            self.interval_s * (2.0 ** self.consecutive_failures),
        )

    # ------------------------------------------------------------------ once

    def compact_once(self, force: bool = False) -> Optional[str]:
        """One fold → snapshot → prune cycle; returns the new generation name.

        Returns None when the delta is below ``min_delta_rows`` (nothing
        worth folding) and ``force`` is False. Failure accounting lives here
        (not only in the background loop) so synchronously driven compactors
        report the same ``consecutive_failures``/``last_error`` health.
        """
        try:
            name = self._compact_once(force)
        except Exception as e:
            self.consecutive_failures += 1
            self.last_error = e
            raise
        else:
            self.consecutive_failures = 0
            self.last_error = None
            return name

    def _compact_once(self, force: bool = False) -> Optional[str]:
        svc = self.service
        with get_tracer().span("compact"):
            failpoint("compact.cycle")
            with svc._flush_lock:
                t_lock = time.perf_counter()
                with svc._lock:
                    pending = svc.delta.n
                if pending < self.min_delta_rows and not force:
                    return None
                svc._refresh_locked()  # folds + seals the WAL segment
                t_cap = time.perf_counter()
                with svc._lock:
                    # capture the state tree — array REFERENCES, no blob I/O.
                    # Index mutations are replacements (extend swaps arrays),
                    # so the captured refs stay immutable after the locks drop
                    # and the blobs stream to disk without blocking the
                    # service.
                    state = build_state(svc.index, live=svc._live.copy())
                    wal_seq = svc._wal_folded_seq
                t_end = time.perf_counter()
                self.last_lock_s = t_end - t_lock
                self.last_capture_s = t_end - t_cap
            name = write_generation(self.root, state, wal_seq=wal_seq)
            self.generations_written += 1
            self._prune(wal_seq)
            return name

    def _prune(self, newest_covered_seq: int) -> None:
        prune_generations(self.root, keep=self.keep_generations)
        # WAL segments are deletable once the OLDEST remaining generation
        # covers them — an operator rolling back to it must still replay
        # everything after its wal_seq. With keep_generations snapshots at
        # monotone wal_seqs, that is the (keep-1)-back snapshot's seq; being
        # conservative, prune only below the oldest remaining generation.
        import json
        import os

        kept = list_generations(self.root)
        seqs: List[int] = []
        for g in kept:
            try:
                with open(os.path.join(self.root, g, "manifest.json")) as f:
                    seqs.append(int(json.load(f)["wal_seq"]))
            except (OSError, ValueError, KeyError):
                seqs.append(0)
        covered = min(seqs) if seqs else newest_covered_seq
        wal: WriteAheadLog = self.service.wal
        wal.prune(covered)

    # ------------------------------------------------------------ background

    def start(self) -> None:
        """Run ``compact_once`` on a daemon thread every ``interval_s``."""
        assert self._thread is None, "compactor already running"
        self._stop_flag.clear()

        def loop() -> None:
            set_thread_name("compactor")  # root spans tagged for trace triage
            while not self._stop_flag.wait(self._backoff_s()):
                try:
                    self.compact_once()
                except Exception:  # keep compacting through transients
                    # (disk full, etc.): the service must outlive its
                    # compactor. compact_once already recorded last_error and
                    # bumped consecutive_failures — the next wait backs off
                    # exponentially instead of hammering a failing disk
                    pass

        self._thread = threading.Thread(target=loop, name="hqi-compactor", daemon=True)
        self._thread.start()

    def stop(self, final_compact: bool = True) -> None:
        """Stop the thread; optionally snapshot whatever is pending first."""
        if self._thread is not None:
            self._stop_flag.set()
            self._thread.join()
            self._thread = None
        if final_compact:
            self.compact_once()
