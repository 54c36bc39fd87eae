"""Append-only write-ahead log for the serving layer's inserts and deletes.

``HQIService`` keeps live writes in its ``DeltaStore`` (rows and codes on
the index's device) between ``refresh()`` folds — exactly the state a crash
loses. With a WAL attached,
``insert``/``delete`` append a durable record *before* acknowledging, so any
write the caller ever saw survives a crash: recovery loads the newest
snapshot and replays the WAL tail into a fresh delta store
(store/recovery.py), reproducing the same external ids bit-for-bit.

Record framing (binary, little-endian), one record per committed write:

    u32 magic   "WAL1"
    u64 seq     monotonically increasing across segments
    u8  kind    1 = insert, 2 = delete
    u32 len     payload byte length
    u32 crc32   of the payload bytes
    len bytes   payload: np.savez archive of named arrays (vectors, ids,
                per-column values/null-masks for inserts; ids for deletes)

A torn tail — the process died mid-append — fails the length or CRC check.
In the FINAL segment that is the expected crash signature: replay stops
there, acknowledged records are intact (they were flushed before the ack)
and the unacknowledged fragment is cleanly dropped. A bad frame in a SEALED
(non-final) segment is bit rot, not a torn append — replay raises
``WalCorruptionError`` rather than silently skipping the acknowledged
records behind it.

Segments: records append to ``wal-<first_seq>.log``; ``rotate()`` (called by
``refresh()``) seals the current segment and starts the next, so compaction
can ``prune(upto_seq)`` whole sealed segments once a snapshot covers them.

The format is the reference package's (``repro.store.wal``) byte for byte,
so a log written by either package replays in the other. Host-only: the
payloads are numpy arrays.
"""
from __future__ import annotations

import dataclasses
import io
import os
import struct
import threading
import time
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..fault.failpoints import failpoint
from ..fault.retry import with_retries
from ..obs.metrics import get_registry
from ..obs.trace import get_tracer

_MAGIC = 0x57414C31  # "WAL1"
_HEADER = struct.Struct("<IQBII")  # magic, seq, kind, len, crc32

KIND_SEAL = 0  # segment terminator written by rotate(); empty payload
KIND_INSERT = 1
KIND_DELETE = 2

_SEG_PREFIX = "wal-"


class WalCorruptionError(RuntimeError):
    """A sealed segment holds a bad frame: records behind it are unreachable."""


class WalPoisonedError(RuntimeError):
    """The WAL quarantined itself: a group-commit fsync failed past its retry
    budget, so durability can no longer be promised. Writes fail fast with
    this error (``cause`` is the original I/O failure); reads — ``replay``,
    ``segments`` — keep working, and ``clear_poison()`` re-opens the write
    path once the operator has fixed the device."""

    def __init__(self, message: str, *, cause: Optional[BaseException] = None) -> None:
        super().__init__(message)
        self.cause = cause
        if cause is not None:
            self.__cause__ = cause


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _ends_with_seal(data: bytes) -> bool:
    """Does the segment end with an intact seal frame (written by rotate)?

    The durable marker distinguishing 'sealed segment with interior bit rot'
    (replay must raise — acknowledged records sit behind the damage) from
    'open segment with a crash-torn tail' (repairable by truncation).
    """
    if len(data) < _HEADER.size:
        return False
    magic, _seq, kind, plen, crc = _HEADER.unpack_from(data, len(data) - _HEADER.size)
    return magic == _MAGIC and kind == KIND_SEAL and plen == 0 and crc == 0


@dataclasses.dataclass
class WalRecord:
    seq: int
    kind: int  # KIND_INSERT | KIND_DELETE
    arrays: Dict[str, np.ndarray]


def _seg_name(first_seq: int) -> str:
    return f"{_SEG_PREFIX}{first_seq:020d}.log"


def _seg_first_seq(name: str) -> int:
    return int(name[len(_SEG_PREFIX):-len(".log")])


def _encode_payload(arrays: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **{k: np.ascontiguousarray(v) for k, v in arrays.items()})
    return buf.getvalue()


def _decode_payload(payload: bytes) -> Dict[str, np.ndarray]:
    with np.load(io.BytesIO(payload)) as z:
        return {k: z[k] for k in z.files}


def _scan_intact(data: bytes) -> Tuple[int, int]:
    """(byte offset after the last intact record, its seq; 0s when none)."""
    off, last_seq = 0, 0
    while off + _HEADER.size <= len(data):
        magic, seq, _, plen, crc = _HEADER.unpack_from(data, off)
        if magic != _MAGIC:
            break
        payload = data[off + _HEADER.size : off + _HEADER.size + plen]
        if len(payload) < plen or zlib.crc32(payload) != crc:
            break
        off += _HEADER.size + plen
        last_seq = seq
    return off, last_seq


class WriteAheadLog:
    """Single-writer append log over a directory of sealed + one open segment.

    ``sync=True`` (default) fsyncs before any record is acknowledged — the
    durability contract the service's ack depends on. Benchmarks may relax
    it; the frame CRC still bounds the damage to the unsynced tail.

    Group commit: ``stage()`` writes a frame (assigning its seq) without
    fsyncing; ``sync_upto(seq)`` makes it durable, and concurrent callers
    share ONE fsync — the first waiter becomes the leader, fsyncs everything
    staged so far, and wakes the rest, so N threads committing concurrently
    pay ~1 fsync instead of N (the classic WAL group commit). ``append`` is
    stage + sync_upto, preserving the single-caller contract unchanged.
    """

    def __init__(
        self, path: str, *, sync: bool = True, fsync_retries: int = 3
    ) -> None:
        self.path = path
        self.sync = bool(sync)
        # transient-fault budget for the group-commit fsync (fault.retry):
        # an fsync that keeps failing past this many attempts (exponential
        # backoff + jitter between them) poisons the log — see ``poisoned``
        self.fsync_retries = max(1, int(fsync_retries))
        self.poisoned: Optional[BaseException] = None
        # retention floor: while set, prune() keeps every record with
        # seq > pin_seq on disk. The index-evolution tuner pins the seq its
        # off-to-the-side build covers so the compactor can't collect the
        # tail the blue/green swap still has to replay.
        self.pin_seq: Optional[int] = None
        os.makedirs(path, exist_ok=True)
        self._fh: Optional[io.BufferedWriter] = None
        self._seg: Optional[str] = None
        self.last_seq = 0
        # group-commit state: _mu orders frame writes (seq assignment must
        # match file order — replay equates the two); _cv hands off the
        # fsync leadership; _synced_seq is the durable high-water mark
        self._mu = threading.RLock()
        self._cv = threading.Condition(self._mu)
        self._sync_leader = False
        segs = self.segments()
        open_last = False
        for name in segs:
            full = os.path.join(path, name)
            with open(full, "rb") as f:
                data = f.read()
            end, last = _scan_intact(data)
            if last:
                self.last_seq = last
            is_final = name == segs[-1]
            sealed = _ends_with_seal(data)
            if end < len(data) and is_final and not sealed:
                # torn tail from a crash mid-append in the OPEN segment: drop
                # the unacknowledged fragment so the segment stays appendable.
                # Sealed segments (terminated by rotate()'s seal frame) are
                # never repaired — a bad frame there is bit rot over
                # acknowledged records and replay() raises instead.
                with open(full, "r+b") as f:
                    f.truncate(end)
                data = data[:end]
                sealed = _ends_with_seal(data)
            if is_final:
                # resume appending only into an UNSEALED final segment; after
                # a seal the next append starts a fresh segment
                open_last = not sealed
        if open_last:
            self._open_segment(segs[-1])
        self._synced_seq = self.last_seq  # everything on disk is durable

    # ------------------------------------------------------------------ write

    def _open_segment(self, name: str) -> None:
        if self._fh is not None:
            self._fh.close()
        self._seg = name
        self._fh = open(os.path.join(self.path, name), "ab")
        if self.sync:
            # make the directory entry itself durable: fsyncing the FILE
            # does not persist its existence in wal/ — without this, a
            # power loss after the ack could lose the whole new segment
            _fsync_dir(self.path)

    def stage(self, kind: int, arrays: Dict[str, np.ndarray]) -> int:
        """Write one record to the OS (ordered, CRC-framed) without fsync.

        Returns its sequence number; the record is NOT durable until a
        ``sync_upto`` covering that seq returns. The payload is encoded
        outside the lock, so concurrent stagers only serialize on the
        actual frame write (which fixes seq order = file order = replay
        order, the invariant recovery's id-stability assert depends on).
        """
        if self.poisoned is not None:
            raise WalPoisonedError(
                "WAL quarantined after unrecoverable fsync failure",
                cause=self.poisoned,
            )
        failpoint("wal.stage")
        payload = _encode_payload(arrays)
        with self._mu:
            if self._fh is None:
                self._open_segment(_seg_name(self.last_seq + 1))
            seq = self.last_seq + 1
            frame = _HEADER.pack(_MAGIC, seq, kind, len(payload), zlib.crc32(payload))
            self._fh.write(frame + payload)
            self._fh.flush()
            self.last_seq = seq
        return seq

    def sync_upto(self, seq: int) -> int:
        """Block until record ``seq`` is durable; batches concurrent callers.

        The first caller to find ``seq`` unsynced becomes the leader: it
        fsyncs ONCE, covering every record staged up to that moment, then
        wakes all waiters — whoever's seq the batch covered returns without
        issuing its own fsync. Returns the durable high-water mark.
        """
        if not self.sync:
            return self.last_seq
        with self._cv:
            while True:
                if self._synced_seq >= seq:
                    return self._synced_seq
                if not self._sync_leader:
                    break  # take leadership for the next fsync batch
                self._cv.wait()
            self._sync_leader = True
            fh = self._fh
            upto = self.last_seq
        ok = False
        err: Optional[BaseException] = None
        try:
            if fh is not None:
                with get_tracer().span("wal.fsync", upto=upto):
                    t0 = time.perf_counter()

                    def _sync() -> None:
                        failpoint("wal.fsync")
                        os.fsync(fh.fileno())

                    try:
                        # transient I/O faults are retried with bounded
                        # exponential backoff; a failure that outlives the
                        # budget poisons the log (durability can no longer be
                        # promised) and propagates to every caller whose
                        # record this batch covered
                        with_retries(
                            _sync,
                            attempts=self.fsync_retries,
                            retry_on=(OSError,),
                            on_retry=lambda _a, _e: get_registry()
                            .counter("wal.fsync_retries")
                            .inc(1),
                        )
                    except BaseException as e:
                        err = e
                        raise
                    get_registry().histogram("wal.fsync_s").observe(
                        time.perf_counter() - t0
                    )
            ok = True
        finally:
            with self._cv:
                self._sync_leader = False
                if ok and fh is not None:
                    self._synced_seq = max(self._synced_seq, upto)
                elif err is not None and not isinstance(err, KeyboardInterrupt):
                    self.poisoned = err
                self._cv.notify_all()
        return self._synced_seq

    @property
    def synced_seq(self) -> int:
        """Durable high-water mark: the largest seq an ack may cover."""
        return self._synced_seq

    def clear_poison(self) -> None:
        """Operator hook: re-open the write path after fixing the device.

        Safe because a poisoned fsync never advanced ``_synced_seq`` — any
        record the failure left non-durable was never acknowledged, and the
        next successful group fsync covers it or its torn remains truncate
        on restart.
        """
        self.poisoned = None

    def append(self, kind: int, arrays: Dict[str, np.ndarray]) -> int:
        """Commit one record durably; returns its sequence number."""
        seq = self.stage(kind, arrays)
        self.sync_upto(seq)
        return seq

    def rotate(self) -> None:
        """Seal the open segment; the next append starts a fresh one.

        Called at ``refresh()`` so sealed segments map onto fold boundaries
        and compaction can drop them wholesale once a snapshot covers them.
        Writes a durable seal frame — the marker that tells a later reopen
        this segment's content is complete (a bad frame inside it is bit
        rot to surface, not a torn tail to truncate).
        """
        with self._cv, get_tracer().span("wal.rotate"):
            while self._sync_leader:
                # an in-flight group fsync holds the segment's fd; closing
                # it under the leader would fsync a dead descriptor
                self._cv.wait()
            if self._fh is not None:
                self._fh.write(_HEADER.pack(_MAGIC, self.last_seq, KIND_SEAL, 0, 0))
                self._fh.flush()
                if self.sync:
                    os.fsync(self._fh.fileno())
                self._fh.close()
                self._fh = None
                self._seg = None
            self._synced_seq = max(self._synced_seq, self.last_seq)
            self._cv.notify_all()

    def close(self) -> None:
        self.rotate()

    # ------------------------------------------- service-facing commit helpers

    def log_insert(
        self,
        vectors: np.ndarray,
        ids: np.ndarray,
        columns: Optional[Dict[str, np.ndarray]] = None,
        null_masks: Optional[Dict[str, np.ndarray]] = None,
    ) -> int:
        """Commit one acknowledged insert batch (ids as the service assigned)."""
        return self.append(KIND_INSERT, insert_arrays(vectors, ids, columns, null_masks))

    def log_delete(self, ids) -> int:
        """Commit one acknowledged delete request (replay is idempotent)."""
        return self.append(
            KIND_DELETE, {"ids": np.atleast_1d(np.asarray(ids, dtype=np.int64))}
        )

    def stage_insert(
        self,
        vectors: np.ndarray,
        ids: np.ndarray,
        columns: Optional[Dict[str, np.ndarray]] = None,
        null_masks: Optional[Dict[str, np.ndarray]] = None,
    ) -> int:
        """Stage an insert for group commit; durable after ``sync_upto``."""
        return self.stage(KIND_INSERT, insert_arrays(vectors, ids, columns, null_masks))

    def stage_delete(self, ids) -> int:
        """Stage a delete for group commit; durable after ``sync_upto``."""
        return self.stage(
            KIND_DELETE, {"ids": np.atleast_1d(np.asarray(ids, dtype=np.int64))}
        )

    # ------------------------------------------------------------------- read

    def segments(self) -> List[str]:
        out = [
            e
            for e in os.listdir(self.path)
            if e.startswith(_SEG_PREFIX) and e.endswith(".log")
        ]
        return sorted(out, key=_seg_first_seq)

    def replay(self, after_seq: int = 0) -> Iterator[WalRecord]:
        """Yield intact records with seq > ``after_seq``, in commit order.

        A bad frame in an UNSEALED final segment is the crash-torn tail:
        replay stops cleanly there (everything before it was acknowledged
        and survives; the fragment never was). A bad frame anywhere else —
        a segment rotate() terminated with its seal frame, or a non-final
        segment — raises ``WalCorruptionError``: acknowledged records sit
        behind the damage and must not be silently skipped.
        """
        segs = self.segments()
        for i, name in enumerate(segs):
            is_final = name == segs[-1]
            if not is_final and _seg_first_seq(segs[i + 1]) <= after_seq + 1:
                # every record here has seq < the successor's first, all of
                # them <= after_seq: fully covered by the caller's snapshot,
                # retained only for older generations — skip without reading
                # (so bit rot in a covered segment can't block a restart the
                # newest snapshot + tail could fully serve)
                continue
            with open(os.path.join(self.path, name), "rb") as f:
                data = f.read()
            torn_ok = is_final and not _ends_with_seal(data)
            off = 0
            while off + _HEADER.size <= len(data):
                magic, seq, kind, plen, crc = _HEADER.unpack_from(data, off)
                payload = data[off + _HEADER.size : off + _HEADER.size + plen]
                bad = (
                    magic != _MAGIC
                    or len(payload) < plen
                    or zlib.crc32(payload) != crc
                )
                if bad:
                    if torn_ok:
                        return  # torn tail: drop the unacknowledged fragment
                    raise WalCorruptionError(
                        f"bad frame at byte {off} of sealed segment {name}; "
                        f"acknowledged records behind it would be lost"
                    )
                off += _HEADER.size + plen
                if kind != KIND_SEAL and seq > after_seq:
                    yield WalRecord(seq=seq, kind=kind, arrays=_decode_payload(payload))
            if off != len(data):  # trailing partial header
                if torn_ok:
                    return
                raise WalCorruptionError(
                    f"partial frame header at byte {off} of sealed segment {name}"
                )

    # ------------------------------------------------------------------ prune

    def prune(self, upto_seq: int) -> List[str]:
        """Delete sealed segments fully covered by a snapshot; returns names.

        A segment is deletable when every record it holds has
        seq <= ``upto_seq`` — i.e. the NEXT segment starts at or below
        ``upto_seq + 1`` — and it is not the open segment. ``pin_seq``
        (when set) clamps the horizon so records a pending swap must replay
        survive any concurrent pruner.
        """
        if self.pin_seq is not None:
            upto_seq = min(int(upto_seq), int(self.pin_seq))
        segs = self.segments()
        doomed: List[str] = []
        for i, name in enumerate(segs):
            nxt = _seg_first_seq(segs[i + 1]) if i + 1 < len(segs) else self.last_seq + 1
            if name != self._seg and nxt <= upto_seq + 1:
                doomed.append(name)
        for name in doomed:
            os.remove(os.path.join(self.path, name))
        return doomed


# ---------------------------------------------------------------------------
# Record payload helpers (shared by service.py's commit and recovery's replay)
# ---------------------------------------------------------------------------


def insert_arrays(
    vectors: np.ndarray,
    ids: np.ndarray,
    columns: Optional[Dict[str, np.ndarray]],
    null_masks: Optional[Dict[str, np.ndarray]],
) -> Dict[str, np.ndarray]:
    out = {
        "vectors": np.atleast_2d(np.asarray(vectors, dtype=np.float32)),
        "ids": np.asarray(ids, dtype=np.int64),
    }
    for name, vals in (columns or {}).items():
        out[f"col.{name}"] = np.asarray(vals)
    for name, nm in (null_masks or {}).items():
        out[f"nm.{name}"] = np.asarray(nm)
    return out


def split_insert_arrays(
    arrays: Dict[str, np.ndarray]
) -> Tuple[np.ndarray, np.ndarray, Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """(vectors, ids, columns, null_masks) back out of an insert record."""
    columns = {
        k[len("col."):]: v for k, v in arrays.items() if k.startswith("col.")
    }
    null_masks = {k[len("nm."):]: v for k, v in arrays.items() if k.startswith("nm.")}
    return arrays["vectors"], arrays["ids"], columns, null_masks
