"""Versioned on-disk snapshots of an ``HQIIndex`` (+ serving state).

The index is exactly the state that is expensive to recompute — qd-tree
partitions mined from the historical workload, per-partition IVF quantizers,
the packed arena, trained PQ codebooks — yet before this module the repo
could only rebuild it from raw tuples on every process start. A snapshot
makes restart O(mmap) instead of O(k-means).

Format (one *generation* per save, self-describing and versioned):

    <root>/
      CURRENT                  # text file: name of the newest valid generation
      gen-000001/
        manifest.json          # JSON tree mirroring HQIIndex.to_state(); every
                               # array leaf replaced by an {"__npy__": ...}
                               # record (file, dtype, shape, nbytes)
        arrays/<dotted.path>.npy
      wal/                     # owned by store/wal.py

Array blobs are plain ``.npy`` files written with ``np.save`` and loaded with
``np.load(mmap_mode="r")`` — zero-copy: the loaded index's packed rows, PQ
codes, posting-list tables, and bitmap cache are memory-mapped pages shared
with the OS cache, so load cost is metadata-only and independent of DB size.

Crash safety: a generation is staged as ``gen-XXXXXX.tmp`` (arrays first,
manifest LAST, both fsync'd), atomically renamed into place, and only then is
``CURRENT`` swapped (tmp-write + rename). A crash at any point leaves either
the old generation current or a ``.tmp`` directory the loader ignores and the
next save sweeps. ``load_snapshot`` validates the manifest and every referenced
blob (existence + byte size) and falls back to older generations when the
newest is torn.

The format (manifest keys, dtypes, shapes, blob names) is the reference
package's (``repro.store.snapshot``), so a generation written by either
package loads in the other. What differs on the card: ``build_state``
captures the arena's device tensors themselves (no read-back under the
caller's lock), and ``write_generation`` copies each to the host as it
writes its blob; ``load_snapshot`` loads onto ``device`` ("cuda" unless the
caller asks for the CPU) through ``HQIIndex.from_state``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Set

import numpy as np
import torch

from ..core.hqi import HQIIndex
from ..core.kmeans import Device
from ..fault.failpoints import failpoint
from ..fault.retry import with_retries
from ..obs.metrics import get_registry
from ..obs.trace import get_tracer
from .wal import _fsync_dir

FORMAT = "hqi-snapshot"
VERSION = 1

_GEN_PREFIX = "gen-"
_ARRAY_KEY = "__npy__"
_PINNED_FILE = "PINNED"

# One process may run several generation writers (the background compactor
# AND the index-evolution tuner): serialize name allocation + the final
# rename so two concurrent saves can't both claim gen-N. Blob streaming
# happens inside too — both writers are background work, and serial writes
# beat interleaved disk traffic.
_WRITE_LOCK = threading.Lock()


# ---------------------------------------------------------------------------
# State-tree <-> (manifest JSON, array blobs)
# ---------------------------------------------------------------------------


def _externalize(node: Any, arrays: Dict[str, np.ndarray], prefix: str) -> Any:
    """Replace every ndarray leaf with a blob record; collect arrays by file.

    A tensor leaf (a device tensor ``build_state`` captured) is copied to the
    host here, outside the service's locks, and recorded as its numpy array.
    Blob filenames are percent-quoted (user-supplied column names flow into
    the key path — a ``/`` or other separator must not escape ``arrays/``).
    """
    if isinstance(node, torch.Tensor):
        node = node.detach().cpu().numpy()
    if isinstance(node, np.ndarray):
        from urllib.parse import quote

        key = prefix.strip(".") or "root"
        fname = quote(key, safe="") + ".npy"
        assert fname not in arrays, f"duplicate array key {key}"
        arrays[fname] = node
        return {
            _ARRAY_KEY: fname,
            "dtype": str(node.dtype),
            "shape": list(node.shape),
        }
    if isinstance(node, dict):
        return {
            str(k): _externalize(v, arrays, f"{prefix}.{k}") for k, v in node.items()
        }
    if isinstance(node, (list, tuple)):
        return [_externalize(v, arrays, f"{prefix}.{i}") for i, v in enumerate(node)]
    if isinstance(node, (np.integer,)):
        return int(node)
    if isinstance(node, (np.floating,)):
        return float(node)
    if isinstance(node, (np.bool_,)):
        return bool(node)
    assert node is None or isinstance(node, (bool, int, float, str)), (
        f"unserializable snapshot leaf at {prefix!r}: {type(node).__name__}"
    )
    return node


def _internalize(node: Any, arrays_dir: str, *, mmap: bool = True) -> Any:
    """Inverse of ``_externalize``: blob records become (mmap'd) ndarrays."""
    if isinstance(node, dict):
        if _ARRAY_KEY in node:
            fname = node[_ARRAY_KEY]
            if os.path.basename(fname) != fname or fname.startswith(".."):
                raise SnapshotError(f"unsafe blob path {fname!r} in manifest")
            path = os.path.join(arrays_dir, fname)
            arr = np.load(path, mmap_mode="r" if mmap else None)
            if tuple(arr.shape) != tuple(node["shape"]) or str(arr.dtype) != node["dtype"]:
                raise SnapshotError(
                    f"blob {node[_ARRAY_KEY]} does not match its manifest record: "
                    f"{arr.dtype}{list(arr.shape)} vs {node['dtype']}{node['shape']}"
                )
            return arr
        return {k: _internalize(v, arrays_dir, mmap=mmap) for k, v in node.items()}
    if isinstance(node, list):
        return [_internalize(v, arrays_dir, mmap=mmap) for v in node]
    return node


class SnapshotError(RuntimeError):
    """No loadable generation (missing, torn, or version-incompatible)."""


# ---------------------------------------------------------------------------
# Generations
# ---------------------------------------------------------------------------


def _gen_name(gen: int) -> str:
    return f"{_GEN_PREFIX}{gen:06d}"


def _gen_number(name: str) -> int:
    return int(name[len(_GEN_PREFIX):])


def list_generations(root: str) -> List[str]:
    """Completed generation names under ``root``, oldest first."""
    if not os.path.isdir(root):
        return []
    out = [
        e
        for e in os.listdir(root)
        if e.startswith(_GEN_PREFIX)
        and not e.endswith(".tmp")
        and os.path.isdir(os.path.join(root, e))
    ]
    return sorted(out, key=_gen_number)


def _atomic_write(path: str, data: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path))


@dataclasses.dataclass
class Snapshot:
    """A loaded generation: the index plus its serving-layer sidecar state."""

    index: HQIIndex
    live: Optional[np.ndarray]  # bool [db.n] tombstone mask (None = all live)
    wal_seq: int  # last WAL record folded into this snapshot
    generation: int
    path: str  # the generation directory


def build_state(index: HQIIndex, live: Optional[np.ndarray] = None) -> Dict[str, Any]:
    """Capture the snapshot state tree — array and tensor *references*, no
    blob I/O and no device read-back.

    Cheap enough to run under the serving layer's flush lock (the compactor
    does): index mutations are replacements (the arena's tensors included,
    ``PackedArena.updated``), so captured references stay immutable while
    ``write_generation`` copies them to the host and streams them to disk
    outside any lock.
    """
    state: Dict[str, Any] = {"index": index.to_state(host=False)}
    if live is not None:
        state["live"] = np.asarray(live, dtype=bool)
    return state


def save_snapshot(
    root: str,
    index: HQIIndex,
    *,
    live: Optional[np.ndarray] = None,
    wal_seq: int = 0,
) -> str:
    """Write one new generation; returns its name (e.g. ``gen-000002``).

    ``live`` is the serving layer's tombstone mask over ``index.db`` rows and
    ``wal_seq`` the last WAL record this snapshot covers — recovery replays
    only records after it. Both default to the bare-index case.
    """
    return write_generation(root, build_state(index, live), wal_seq=wal_seq)


def write_generation(
    root: str,
    state: Dict[str, Any],
    *,
    wal_seq: int = 0,
    meta: Optional[Dict[str, Any]] = None,
    set_current: bool = True,
) -> str:
    """Persist a captured state tree as the next generation (crash-safe).

    ``meta`` stamps free-form provenance into the manifest (the tuner records
    its trigger reason there). ``set_current=False`` writes the generation
    WITHOUT flipping ``CURRENT`` — the blue/green pattern: the tuner persists
    the candidate layout first and promotes it (``set_current()``) only after
    the in-memory swap succeeded, so a failed swap leaves restarts loading
    the generation that matches what is actually serving.
    """
    with get_tracer().span("snapshot.write", wal_seq=int(wal_seq)):
        with _WRITE_LOCK:
            return _write_generation(
                root, state, wal_seq=wal_seq, meta=meta, set_current=set_current
            )


def _write_generation(
    root: str,
    state: Dict[str, Any],
    *,
    wal_seq: int = 0,
    meta: Optional[Dict[str, Any]] = None,
    set_current: bool = True,
) -> str:
    os.makedirs(root, exist_ok=True)
    gens = list_generations(root)
    gen = (_gen_number(gens[-1]) + 1) if gens else 1
    name = _gen_name(gen)
    final_dir = os.path.join(root, name)
    tmp_dir = final_dir + ".tmp"
    # sweep a stale stage from a previous crashed save
    if os.path.isdir(tmp_dir):
        import shutil

        shutil.rmtree(tmp_dir)

    arrays: Dict[str, np.ndarray] = {}
    tree = _externalize(state, arrays, "")
    manifest = {
        "format": FORMAT,
        "version": VERSION,
        "generation": gen,
        "created_unix": time.time(),
        "wal_seq": int(wal_seq),
        "state": tree,
    }
    if meta is not None:
        manifest["meta"] = meta

    arrays_dir = os.path.join(tmp_dir, "arrays")
    os.makedirs(arrays_dir)
    for fname, arr in arrays.items():
        path = os.path.join(arrays_dir, fname)

        def _write_blob(path: str = path, arr: np.ndarray = arr) -> None:
            failpoint("snapshot.write")
            # "wb" truncates, so a retry after a partial write starts clean
            with open(path, "wb") as f:
                np.save(f, np.ascontiguousarray(arr))
                f.flush()
                os.fsync(f.fileno())

        # transient blob-I/O faults retry with bounded backoff; a failure
        # that outlives the budget aborts THIS generation only — the tmp dir
        # never renamed into place, CURRENT untouched, old generations intact
        with_retries(
            _write_blob,
            retry_on=(OSError,),
            on_retry=lambda _a, _e: get_registry()
            .counter("snapshot.write_retries")
            .inc(1),
        )
    # manifest LAST: its presence marks the generation complete
    with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp_dir)
    os.replace(tmp_dir, final_dir)
    _fsync_dir(root)
    if set_current:
        _atomic_write(os.path.join(root, "CURRENT"), name + "\n")
    return name


def current_generation(root: str) -> Optional[str]:
    """The generation name ``CURRENT`` points at, or None."""
    cpath = os.path.join(root, "CURRENT")
    if not os.path.isfile(cpath):
        return None
    with open(cpath) as f:
        name = f.read().strip()
    return name or None


def set_current(root: str, name: str) -> None:
    """Atomically repoint ``CURRENT`` at an existing, complete generation.

    The promotion half of a blue/green save (``write_generation(...,
    set_current=False)``) — and the demotion half of a rollback.
    """
    if _validate_generation(root, name) is None:
        raise SnapshotError(f"cannot promote {name!r}: not a loadable generation")
    _atomic_write(os.path.join(root, "CURRENT"), name + "\n")


# ---------------------------------------------------------------------------
# Pinning — generations retention must not collect (rollback targets)
# ---------------------------------------------------------------------------


def pinned_generations(root: str) -> Set[str]:
    """Generation names listed in ``<root>/PINNED`` (one per line)."""
    path = os.path.join(root, _PINNED_FILE)
    if not os.path.isfile(path):
        return set()
    with open(path) as f:
        return {line.strip() for line in f if line.strip()}


def _write_pinned(root: str, names: Set[str]) -> None:
    path = os.path.join(root, _PINNED_FILE)
    if not names:
        if os.path.isfile(path):
            os.remove(path)
            _fsync_dir(root)
        return
    _atomic_write(path, "".join(n + "\n" for n in sorted(names)))


def pin_generation(root: str, name: str) -> None:
    """Shield ``name`` from ``prune_generations`` until unpinned.

    Durable (a ``PINNED`` file beside ``CURRENT``), so every pruner in every
    process respects it — the tuner pins the displaced generation after a
    swap so instant rollback survives however many compaction cycles run
    in between.
    """
    _write_pinned(root, pinned_generations(root) | {name})


def unpin_generation(root: str, name: str) -> None:
    """Release a pin; a no-op when ``name`` was not pinned."""
    _write_pinned(root, pinned_generations(root) - {name})


def _validate_generation(root: str, name: str) -> Optional[dict]:
    """Parsed manifest if the generation is complete and loadable, else None."""
    gen_dir = os.path.join(root, name)
    mpath = os.path.join(gen_dir, "manifest.json")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if manifest.get("format") != FORMAT or manifest.get("version") != VERSION:
        return None
    arrays_dir = os.path.join(gen_dir, "arrays")

    def blobs_ok(node: Any) -> bool:
        if isinstance(node, dict):
            if _ARRAY_KEY in node:
                fname = node[_ARRAY_KEY]
                if os.path.basename(fname) != fname or fname.startswith(".."):
                    return False
                path = os.path.join(arrays_dir, fname)
                if not os.path.isfile(path):
                    return False
                # npy header (~128 B) + payload; a short file is a torn write
                expect = int(np.prod(node["shape"])) * np.dtype(node["dtype"]).itemsize
                return os.path.getsize(path) >= expect
            return all(blobs_ok(v) for v in node.values())
        if isinstance(node, list):
            return all(blobs_ok(v) for v in node)
        return True

    return manifest if blobs_ok(manifest.get("state", {})) else None


def load_snapshot(root: str, *, mmap: bool = True, device: Device = "cuda") -> Snapshot:
    """Load the newest valid generation (``CURRENT`` first, then fallback)
    onto ``device``.

    Raises ``SnapshotError`` when no generation is loadable. ``mmap=False``
    forces full in-memory loads (tests / copying a snapshot elsewhere). On a
    machine without a card the default device fails the load: it does not
    fall back to the CPU.
    """
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        # the caller's error, not a torn generation: never load elsewhere
        raise RuntimeError(f"load_snapshot(device={device!r}): no CUDA device")
    with get_tracer().span("snapshot.load"):
        return _load_snapshot(root, mmap=mmap, device=device)


def _load_snapshot(root: str, *, mmap: bool = True, device: Device = "cuda") -> Snapshot:
    failpoint("snapshot.load")
    candidates: List[str] = []
    current = os.path.join(root, "CURRENT")
    if os.path.isfile(current):
        with open(current) as f:
            candidates.append(f.read().strip())
    for name in reversed(list_generations(root)):
        if name not in candidates:
            candidates.append(name)
    errors = []
    for name in candidates:
        manifest = _validate_generation(root, name)
        if manifest is None:
            continue
        gen_dir = os.path.join(root, name)
        try:
            state = _internalize(
                manifest["state"], os.path.join(gen_dir, "arrays"), mmap=mmap
            )
            live = state.get("live")
            return Snapshot(
                index=HQIIndex.from_state(state["index"], device=device),
                live=None if live is None else np.asarray(live),
                wal_seq=int(manifest["wal_seq"]),
                generation=int(manifest["generation"]),
                path=gen_dir,
            )
        except torch.cuda.OutOfMemoryError:
            raise  # the device's limit, not damage: an older generation would not fit either
        except Exception as e:
            # a blob torn inside the validator's size margin (npy header) or
            # any other decode failure: this generation is damaged goods —
            # fall back to the next-newest candidate instead of failing a
            # restart that an older, fully-valid generation could serve
            errors.append(f"{name}: {e!r}")
    raise SnapshotError(
        f"no loadable snapshot generation under {root!r}"
        + (f" (damaged candidates: {'; '.join(errors)})" if errors else "")
    )


def prune_generations(
    root: str, keep: int = 2, *, pinned: Iterable[str] = ()
) -> List[str]:
    """Delete all but the newest ``keep`` generations; returns deleted names.

    ``keep=0`` prunes *everything* except the survivors below (it used to be
    a silent no-op, which let "prune all history" calls leak disk forever).
    Negative ``keep`` raises ``ValueError``.

    Never deletes: the generation ``CURRENT`` points at (what a concurrent
    loader follows), names passed via ``pinned``, or names recorded in the
    on-disk ``PINNED`` file (the tuner's rollback targets — see
    ``pin_generation``).
    """
    import shutil

    if keep < 0:
        raise ValueError(f"keep must be >= 0, got {keep}")
    gens = list_generations(root)
    current = current_generation(root)
    pins = set(pinned) | pinned_generations(root)
    cut = gens if keep == 0 else gens[:-keep]
    doomed = [g for g in cut if g != current and g not in pins]
    for name in doomed:
        shutil.rmtree(os.path.join(root, name), ignore_errors=True)
    # sweep stale stages too
    for e in os.listdir(root) if os.path.isdir(root) else []:
        if e.startswith(_GEN_PREFIX) and e.endswith(".tmp"):
            shutil.rmtree(os.path.join(root, e), ignore_errors=True)
    return doomed
