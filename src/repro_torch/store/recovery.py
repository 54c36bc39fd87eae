"""Crash recovery: snapshot load + WAL tail replay → a serving ``HQIService``.

The contract ``open_service`` restores after a crash (or a clean restart):

  * every **acknowledged** write is present — an insert whose ids were
    returned, a delete that returned — because the service committed it to
    the WAL before acknowledging;
  * every **unacknowledged** fragment (a record torn mid-append by the
    crash) is cleanly dropped (frame CRC, see wal.py);
  * external ids are **bit-identical** to the uncrashed process: replayed
    inserts re-enter the delta store in commit order, so id assignment
    (``first_id + position``) reproduces exactly — recovery *verifies* this
    against the ids each record logged at commit time;
  * query results match the uncrashed process: the snapshot restores the
    index (and its arena / router cache) byte-for-byte, onto ``device``
    ("cuda" unless the caller asks for the CPU), and the replayed delta
    scans through the same flush path.

Store layout under one root directory (see snapshot.py for generations):

    root/
      CURRENT, gen-*/          # snapshot generations
      wal/wal-*.log            # the write-ahead log

``init_store`` bootstraps that layout around a freshly built index;
``open_service`` is the restart path. Compaction (compact.py) keeps the WAL
tail short by folding + re-snapshotting in the background.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..core.kmeans import Device
from ..service.service import HQIService, ServiceConfig
from .snapshot import Snapshot, load_snapshot, save_snapshot
from .wal import KIND_DELETE, KIND_INSERT, WriteAheadLog, split_insert_arrays


class RecoveryError(RuntimeError):
    """Replay diverged from the committed log (id mismatch / unknown record)."""


def wal_dir(root: str) -> str:
    return os.path.join(root, "wal")


def init_store(
    root: str,
    index,
    *,
    cfg: Optional[ServiceConfig] = None,
    sync: bool = True,
    device: Device = "cuda",
) -> HQIService:
    """Bootstrap a persistent store around a freshly built index.

    Writes a new snapshot generation, opens the WAL, and returns an
    ``HQIService`` committing every write through it. ``device`` is where
    the service runs ("cuda" unless the caller asks for the CPU): an index
    built elsewhere is refused rather than served from another device. The WAL is opened
    FIRST and the snapshot stamped with its current seq: re-initializing
    over a previously used root must not leave the old incarnation's
    records replayable into the new index (they describe rows it never
    held) — they are marked covered instead, and new commits continue
    above them.
    """
    if index.device.type != torch.device(device).type:
        raise ValueError(f"init_store(device={device!r}): the index is on {index.device}")
    wal = WriteAheadLog(wal_dir(root), sync=sync)
    save_snapshot(
        root, index, live=np.ones(index.db.n, dtype=bool), wal_seq=wal.last_seq
    )
    return HQIService(index, cfg, wal=wal)


def replay_into(svc: HQIService, wal: WriteAheadLog, *, after_seq: int = 0) -> int:
    """Apply the WAL tail to a freshly loaded service; returns #records.

    Records enter through the same state transitions the live service used
    (delta append / tombstone), but WITHOUT re-logging. Insert replay asserts
    that the ids the delta store assigns now equal the ids the service
    acknowledged then — the external-id stability guarantee.
    """
    n = 0
    with svc._lock:
        for rec in wal.replay(after_seq):
            if rec.kind == KIND_INSERT:
                vectors, ids, columns, null_masks = split_insert_arrays(rec.arrays)
                got = svc.delta.insert(vectors, columns or None, null_masks or None)
                if not np.array_equal(got, ids):
                    raise RecoveryError(
                        f"WAL record {rec.seq}: replayed insert ids "
                        f"{got.tolist()} != committed ids {ids.tolist()}"
                    )
            elif rec.kind == KIND_DELETE:
                svc._delete_locked(rec.arrays["ids"])
            else:
                raise RecoveryError(f"WAL record {rec.seq}: unknown kind {rec.kind}")
            n += 1
    return n


def open_service(
    root: str,
    *,
    cfg: Optional[ServiceConfig] = None,
    sync: bool = True,
    mmap: bool = True,
    device: Device = "cuda",
) -> HQIService:
    """Load the newest valid snapshot onto ``device``, replay the WAL tail,
    resume serving.

    The returned service answers queries bit-identically to an uncrashed
    process: snapshot blobs are mmap'd and copied to ``device``, acknowledged
    writes after the snapshot re-enter the delta store in commit order, and
    the WAL stays attached so new writes keep committing durably.
    """
    snap: Snapshot = load_snapshot(root, mmap=mmap, device=device)
    svc = HQIService(snap.index, cfg)
    if snap.live is not None:
        # writable copy: tombstones mutate the mask in place, mmap is read-only
        svc._live = np.array(snap.live, dtype=bool)
    wal = WriteAheadLog(wal_dir(root), sync=sync)
    # compaction may have pruned EVERY segment (snapshot covers them all);
    # new commits must continue above the snapshot's seq, never restart at 1,
    # or the next recovery would skip them as already-covered
    wal.last_seq = max(wal.last_seq, snap.wal_seq)
    replay_into(svc, wal, after_seq=snap.wal_seq)
    svc.wal = wal
    svc._wal_folded_seq = snap.wal_seq
    # every record on disk is now applied (replayed or snapshot-covered); a
    # fold may claim up to here — the group-commit apply path advances it
    svc._applied_seq = wal.last_seq
    return svc
