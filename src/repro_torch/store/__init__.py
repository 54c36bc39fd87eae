"""Index persistence & recovery: versioned snapshots, serving WAL, compaction.

Public API:
    save_snapshot / load_snapshot / Snapshot — versioned manifest + .npy
        generations of a full ``HQIIndex`` (+ live mask), the reference's
        format; loaded onto ``device`` ("cuda" by default); build_state /
        write_generation split capture (device tensors by reference) from
        the host copy and blob I/O
    list_generations / prune_generations — generation lifecycle
    current_generation / set_current / pin_generation / unpin_generation /
        pinned_generations — blue/green promotion + rollback-target pinning
    WriteAheadLog / WalRecord — append-only commit log for serving writes
    init_store / open_service / replay_into — bootstrap + crash recovery
    Compactor — background fold → snapshot → prune loop
"""
from .compact import Compactor  # noqa: F401
from .recovery import (  # noqa: F401
    RecoveryError,
    init_store,
    open_service,
    replay_into,
    wal_dir,
)
from .snapshot import (  # noqa: F401
    Snapshot,
    SnapshotError,
    build_state,
    current_generation,
    list_generations,
    load_snapshot,
    pin_generation,
    pinned_generations,
    prune_generations,
    save_snapshot,
    set_current,
    unpin_generation,
    write_generation,
)
from .wal import (  # noqa: F401
    KIND_DELETE,
    KIND_INSERT,
    WalCorruptionError,
    WalPoisonedError,
    WalRecord,
    WriteAheadLog,
)
