"""Index-wide packed vector arena — the storage side of the execution engine.

Every partition's IVF stores its vectors re-ordered so each posting list is a
contiguous slice (see ivf.py). The arena concatenates those per-partition
``packed`` arrays into ONE index-wide tensor on the index's device and
exposes a *global* posting-list table: posting list ``g`` of any partition
lives at ``packed[list_start[g] : list_start[g] + list_len[g]]``.

This is what lets the planner bucket work units across partitions and
templates: one ``index_select`` on the device serves every partition, so one
kernel dispatch can mix posting lists from anywhere in the index. ``gid``
(also on the device) maps packed rows straight back to the caller's tuple
ids, so executor output needs no per-partition id translation. The
posting-list table and the row maps the planner reads on the host stay
numpy.

Compressed storage: when a ``PQCodebook`` is attached, the arena also
carries ``codes``, uint8 [N, M] PQ codes on the device, row-aligned with
``packed``, so the engine's ADC scan stage gathers M-byte code rows instead
of d·4-byte vectors and the exact re-rank gathers the surviving f32 rows
from the same arena.

Sharded storage: ``shard()`` splits the arena into contiguous posting-list
ranges, one per model-axis rank of a device mesh (``launch/mesh.py``). Rank
r's rows, ids and PQ codes are a slice of the base arena on the rank's
device: a view where that is the arena's device, a copy otherwise. ``gid``
stays *global* in every shard, so the sharded executor's outputs need no
cross-rank id translation, and ``packed_bitmap`` keeps working per shard
because bitmap slices are partition-local already.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import kmeans as km
from .ivf import IVFIndex
from .pq import PQCodebook, encode_pq_tensor


def _nearest_cuts(boundary_rows: np.ndarray, targets: np.ndarray) -> np.ndarray:
    """Index of the boundary NEAREST each row target (not the next one up —
    snapping up degenerates badly under skew, e.g. partitions of 10 and 900
    rows split 2 ways must cut at 10, not at the end)."""
    hi = np.clip(
        np.searchsorted(boundary_rows, targets, side="left"),
        1, len(boundary_rows) - 1,
    )
    lo = hi - 1
    pick_lo = (targets - boundary_rows[lo]) <= (boundary_rows[hi] - targets)
    return np.where(pick_lo, lo, hi).astype(np.int64)


@dataclasses.dataclass
class PackedArena:
    """Concatenated posting-list storage for one or more IVF partitions."""

    packed: torch.Tensor  # f32 [N, d] on ``device`` — all partitions, posting-list order
    gid: torch.Tensor  # i64 [N] on ``device`` — packed row -> caller tuple id
    local_of: np.ndarray  # i64 [N] — packed row -> partition-local vector idx
    list_start: np.ndarray  # i64 [G] — first packed row of global list g
    list_len: np.ndarray  # i64 [G]
    list_base: np.ndarray  # i64 [P + 1] — partition p owns lists [base[p], base[p+1])
    part_row: np.ndarray  # i64 [P + 1] — partition p owns packed rows [row[p], row[p+1])
    centroids: List[np.ndarray]  # per-partition coarse quantizer
    metric: str
    pq: Optional[PQCodebook] = None  # index-wide codebook (compressed mode)
    codes: Optional[torch.Tensor] = None  # uint8 [N, M] on ``device``, row-aligned with packed
    # the quantizers on the device, for ``probe``
    _cent_dev: List[torch.Tensor] = dataclasses.field(
        default_factory=list, repr=False, compare=False
    )

    def __post_init__(self):
        if not self._cent_dev:
            self._cent_dev = [km.as_tensor(c, self.device) for c in self.centroids]

    @property
    def device(self) -> torch.device:
        return self.packed.device

    @property
    def n(self) -> int:
        return int(self.packed.shape[0])

    @property
    def d(self) -> int:
        return int(self.packed.shape[1])

    @property
    def n_parts(self) -> int:
        return len(self.centroids)

    @property
    def n_lists(self) -> int:
        return int(self.list_start.shape[0])

    def n_lists_of(self, part: int) -> int:
        return int(self.list_base[part + 1] - self.list_base[part])

    def probe(self, part: int, q_vecs: np.ndarray, nprobe: int) -> np.ndarray:
        """nprobe nearest posting lists of partition ``part`` as GLOBAL list ids.

        int32 [m, min(nprobe, n_lists_of(part))]. Same ranking as
        ``IVFIndex.probe`` (same quantizer, same top-m), so engine results
        match the per-query scan path exactly.
        """
        nprobe = int(min(nprobe, self.n_lists_of(part)))
        local = km.topm_centroids(
            q_vecs, self._cent_dev[part], nprobe, metric=self.metric, device=self.device
        )
        return local + np.int32(self.list_base[part])

    def packed_bitmap(self, part: int, local_bitmap: np.ndarray) -> np.ndarray:
        """Partition-local vector-order bitmap -> that partition's packed order."""
        s, e = int(self.part_row[part]), int(self.part_row[part + 1])
        return local_bitmap[self.local_of[s:e]]

    def attach_pq(self, pq: PQCodebook) -> None:
        """Encode the packed rows under ``pq`` (idempotent per codebook).

        Used by the single-index path (``batch_search_ivf``) where the arena
        is built before a codebook exists; ``HQIIndex`` instead passes ``pq``
        at construction.
        """
        if self.pq is pq and self.codes is not None:
            return
        if pq.d != self.d:
            raise ValueError(
                f"PQ codebook shape mismatch: codebook encodes d={pq.d} "
                f"(m={pq.m} subspaces × dsub={pq.dsub}), arena rows have "
                f"d={self.d}"
            )
        self.pq = pq
        self.codes = encode_pq_tensor(pq, self.packed, self.device)

    # ------------------------------------------------------------ persistence

    def to_state(self, host: bool = True) -> dict:
        """The reference's arena state: every array a numpy leaf. With
        ``host=False`` the device tensors (``packed``, ``gid``, ``codes``)
        stay tensor leaves, read nothing back: the store captures them under
        the service's lock and copies them to the host outside it (they are
        replaced, never written in place, so the references stay valid)."""
        read = (lambda t: t.cpu().numpy()) if host else (lambda t: t)
        return {
            "metric": self.metric,
            "packed": read(self.packed),
            "gid": read(self.gid),
            "local_of": self.local_of,
            "list_start": self.list_start,
            "list_len": self.list_len,
            "list_base": self.list_base,
            "part_row": self.part_row,
            "centroids": {str(p): c for p, c in enumerate(self.centroids)},
            "pq": None if self.pq is None else self.pq.to_state(),
            "codes": None if self.codes is None else read(self.codes),
        }

    @staticmethod
    def from_state(state: dict, device: km.Device = "cuda") -> "PackedArena":
        cents = state["centroids"]
        return PackedArena(
            packed=km.as_tensor(np.asarray(state["packed"]), device),
            # a copy: a loaded state's array may be a read-only map of a blob
            gid=torch.from_numpy(np.array(state["gid"], dtype=np.int64)).to(device),
            local_of=np.asarray(state["local_of"]),
            list_start=np.asarray(state["list_start"]),
            list_len=np.asarray(state["list_len"]),
            list_base=np.asarray(state["list_base"]),
            part_row=np.asarray(state["part_row"]),
            centroids=[np.asarray(cents[str(p)]) for p in range(len(cents))],
            metric=state["metric"],
            pq=None if state["pq"] is None else PQCodebook.from_state(state["pq"]),
            codes=(
                None if state["codes"] is None
                else torch.from_numpy(np.array(state["codes"], dtype=np.uint8)).to(device)
            ),
        )

    # ------------------------------------------------------------------ shard

    def shard(
        self,
        n_shards: int,
        bounds: Optional[Sequence[int]] = None,
        devices: Optional[Sequence[torch.device]] = None,
    ) -> "ShardedArena":
        """Split into contiguous slices, one per model-axis rank.

        The split is at *posting-list* granularity — the finest sharding
        that keeps every work unit's posting list whole on one rank, the
        invariant the sharded executor's exact parity rests on — and prefers
        cuts on whole partition boundaries unless partition skew would leave
        the mesh imbalanced, in which case the cut falls on posting-list
        boundaries inside a partition (the standalone-IVF case, one
        partition spread over every rank).

        ``bounds`` (optional, ``n_shards + 1`` monotone GLOBAL list ids with
        ``bounds[0] == 0`` and ``bounds[-1] == n_lists``) pins the split —
        tests use it to force skewed and empty shards. The default cuts at
        the boundary NEAREST each balanced-row target. ``devices`` (one per
        rank; default: this arena's device for every rank) places each
        rank's slice.
        """
        n_shards = int(n_shards)
        assert n_shards >= 1, n_shards
        G = self.n_lists
        row_starts = np.append(self.list_start, self.n)  # i64 [G + 1]
        if bounds is None:
            targets = np.arange(1, n_shards) * (self.n / n_shards)
            # candidate splits at both granularities; keep the better-balanced
            # one (partition slices win ties)
            by_part = self.list_base[
                _nearest_cuts(self.part_row[: self.n_parts + 1], targets)
            ]
            by_list = _nearest_cuts(row_starts, targets)
            candidates = []
            for cuts in (by_part, by_list):
                b = np.concatenate([[0], np.clip(cuts, 0, G), [G]]).astype(np.int64)
                b = np.maximum.accumulate(b)
                candidates.append((int(np.diff(row_starts[b]).max()), b))
            list_bounds = min(candidates, key=lambda c: c[0])[1]
        else:
            list_bounds = np.asarray(bounds, dtype=np.int64)
            assert list_bounds.shape == (n_shards + 1,), list_bounds
            assert list_bounds[0] == 0 and list_bounds[-1] == G, list_bounds
            assert (np.diff(list_bounds) >= 0).all(), list_bounds
        return ShardedArena(
            base=self,
            list_bounds=list_bounds,
            row_bounds=row_starts[list_bounds],
            devices=None if devices is None else list(devices),
        )

    @staticmethod
    def sharded_from_ivf(
        ivf: IVFIndex, n_shards: int, devices: Optional[Sequence[torch.device]] = None
    ) -> "ShardedArena":
        """Sharded single-index arena, memoized per shard count and devices.

        The split reuses the (memoized) ``from_ivf`` arena; a codebook
        attached later needs no invalidation, since each rank cuts its codes
        from the shared ``base`` when they change (``ArenaShard.codes``).
        """
        arena = PackedArena.from_ivf(ivf)
        cache = getattr(ivf, "_sharded_cache", None)
        if cache is None:
            cache = ivf._sharded_cache = {}
        key = (int(n_shards), None if devices is None else tuple(devices))
        if key not in cache:
            cache[key] = arena.shard(n_shards, devices=devices)
        return cache[key]

    # ------------------------------------------------------------ constructors

    @staticmethod
    def from_partitions(
        parts: Sequence[Tuple[np.ndarray, IVFIndex]],
        pq: Optional[PQCodebook] = None,
        device: km.Device = "cuda",
    ) -> "PackedArena":
        """parts: (rows, ivf) pairs; ``rows`` maps ivf-local idx -> caller id."""
        if not parts:
            raise ValueError("arena needs at least one partition")
        metric = parts[0][1].metric
        packed, gid, local_of, starts, lens, cents = [], [], [], [], [], []
        list_base = np.zeros(len(parts) + 1, dtype=np.int64)
        part_row = np.zeros(len(parts) + 1, dtype=np.int64)
        for p, (rows, ivf) in enumerate(parts):
            assert ivf.metric == metric, "mixed-metric partitions"
            packed.append(ivf.packed)
            gid.append(np.asarray(rows, dtype=np.int64)[ivf.order])
            local_of.append(ivf.order)
            starts.append(ivf.offsets[:-1].astype(np.int64) + part_row[p])
            lens.append(np.diff(ivf.offsets).astype(np.int64))
            cents.append(ivf.centroids)
            list_base[p + 1] = list_base[p] + ivf.n_lists
            part_row[p + 1] = part_row[p] + ivf.n
        packed_all = np.concatenate(packed, axis=0)
        return PackedArena(
            packed=km.as_tensor(packed_all, device),
            gid=torch.from_numpy(np.concatenate(gid)).to(device),
            local_of=np.concatenate(local_of),
            list_start=np.concatenate(starts),
            list_len=np.concatenate(lens),
            list_base=list_base,
            part_row=part_row,
            centroids=cents,
            metric=metric,
            pq=pq,
            codes=None if pq is None else encode_pq_tensor(pq, packed_all, device),
        )

    @staticmethod
    def updated(
        old: "PackedArena",
        parts: Sequence[Tuple[np.ndarray, IVFIndex]],
        changed: Sequence[int],
    ) -> "PackedArena":
        """Incremental rebuild after the serving layer extends some partitions.

        ``parts`` is the full current partition list; only partitions in
        ``changed`` are re-derived from their (rows, ivf) pair. A changed
        partition's ivf must be ``IVFIndex.extend`` of the old one: with a
        codebook, its old rows' codes are carried over from ``old`` and only
        the appended rows are encoded on the device. Every other partition's
        packed rows, id map and PQ codes are reused as slices of ``old``'s
        device tensors and its posting-list table as numpy, and one
        ``torch.cat`` per tensor is paid at the end. Partition count and
        order must match.
        """
        assert len(parts) == old.n_parts, "partition count changed; rebuild instead"
        dev = old.device
        changed_set = set(int(c) for c in changed)
        packed, gid, local_of, starts, lens, cents = [], [], [], [], [], []
        codes: List[torch.Tensor] = []
        cent_dev: List[torch.Tensor] = []
        list_base = np.zeros(len(parts) + 1, dtype=np.int64)
        part_row = np.zeros(len(parts) + 1, dtype=np.int64)
        for p, (rows, ivf) in enumerate(parts):
            assert ivf.metric == old.metric, "mixed-metric partitions"
            if p in changed_set:
                packed.append(km.as_tensor(ivf.packed, dev))
                gid.append(torch.from_numpy(np.asarray(rows, dtype=np.int64)[ivf.order]).to(dev))
                local_of.append(ivf.order)
                starts.append(ivf.offsets[:-1].astype(np.int64) + part_row[p])
                lens.append(np.diff(ivf.offsets).astype(np.int64))
                if old.pq is not None:
                    codes.append(_extended_codes(old, p, ivf))
                cent_dev.append(km.as_tensor(ivf.centroids, dev))
                n_p, nl_p = ivf.n, ivf.n_lists
            else:
                r0, r1 = int(old.part_row[p]), int(old.part_row[p + 1])
                l0, l1 = int(old.list_base[p]), int(old.list_base[p + 1])
                packed.append(old.packed[r0:r1])
                gid.append(old.gid[r0:r1])
                local_of.append(old.local_of[r0:r1])
                starts.append(old.list_start[l0:l1] - r0 + part_row[p])
                lens.append(old.list_len[l0:l1])
                if old.pq is not None:
                    codes.append(old.codes[r0:r1])
                cent_dev.append(old._cent_dev[p])
                n_p, nl_p = r1 - r0, l1 - l0
            cents.append(ivf.centroids)
            list_base[p + 1] = list_base[p] + nl_p
            part_row[p + 1] = part_row[p] + n_p
        return PackedArena(
            packed=torch.cat(packed, dim=0),
            gid=torch.cat(gid),
            local_of=np.concatenate(local_of),
            list_start=np.concatenate(starts),
            list_len=np.concatenate(lens),
            list_base=list_base,
            part_row=part_row,
            centroids=cents,
            metric=old.metric,
            pq=old.pq,
            codes=torch.cat(codes, dim=0) if old.pq is not None else None,
            _cent_dev=cent_dev,
        )

    @staticmethod
    def from_ivf(ivf: IVFIndex) -> "PackedArena":
        """Single-index arena on the index's device; ``gid`` is the ivf-local
        vector index. Memoized on the index instance, so repeated
        ``batch_search_ivf`` calls over one IVF pay the O(n) packing once."""
        arena = getattr(ivf, "_arena_cache", None)
        if arena is None:
            arena = PackedArena.from_partitions(
                [(np.arange(ivf.n, dtype=np.int64), ivf)], device=ivf.device
            )
            ivf._arena_cache = arena
        return arena


def _extended_codes(old: PackedArena, p: int, ivf: IVFIndex) -> torch.Tensor:
    """Partition ``p``'s PQ codes after ``IVFIndex.extend`` of its old ivf:
    the old rows (local index < their count) keep their codes from ``old``,
    moved to their new packed positions; the appended rows are encoded."""
    r0, r1 = int(old.part_row[p]), int(old.part_row[p + 1])
    n_old = r1 - r0
    assert ivf.n >= n_old, "a changed partition lost rows; rebuild instead"
    dev = old.device
    new = ivf.order >= n_old
    pos = np.empty(n_old, dtype=np.int64)  # old packed position of each old local index
    pos[old.local_of[r0:r1]] = np.arange(n_old)
    out = torch.empty((ivf.n, old.codes.shape[1]), dtype=torch.uint8, device=dev)
    out[torch.from_numpy(np.nonzero(~new)[0]).to(dev)] = old.codes[
        torch.from_numpy(r0 + pos[ivf.order[~new]]).to(dev)
    ]
    if new.any():
        out[torch.from_numpy(np.nonzero(new)[0]).to(dev)] = encode_pq_tensor(
            old.pq, ivf.packed[new], dev
        )
    return out


def _on(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` itself on its own device (a view stays a view), else a copy."""
    return t if t.device == device else t.to(device)


class ArenaShard:
    """Rank r's slice of the base arena: packed rows ``[row0, row0 + n)``.

    ``packed`` and ``gid`` (still GLOBAL ids) live on ``device``; ``codes``
    is cut from the base arena's codes when first read after they change
    (``attach_pq`` on the base), so a shard never serves stale codes.
    """

    def __init__(self, base: PackedArena, row0: int, row1: int, device: torch.device):
        self.base = base
        self.row0, self.n = int(row0), int(row1 - row0)
        self.device = torch.device(device)
        self.packed = _on(base.packed[self.row0:row1], self.device)
        self.gid = _on(base.gid[self.row0:row1], self.device)
        self._codes: Tuple[Optional[torch.Tensor], Optional[torch.Tensor]] = (None, None)

    @property
    def d(self) -> int:
        return self.base.d

    @property
    def codes(self) -> Optional[torch.Tensor]:
        src = self.base.codes
        if src is None:
            return None
        if self._codes[0] is not src:
            self._codes = (src, _on(src[self.row0:self.row0 + self.n], self.device))
        return self._codes[1]

    def local(self, rows: np.ndarray) -> np.ndarray:
        """Global packed rows -> this shard's rows, clamped into it (the
        clamped rows are masked padding)."""
        return np.clip(rows - self.row0, 0, max(self.n - 1, 0))


@dataclasses.dataclass
class ShardedArena:
    """The arena split into per-rank contiguous posting-list ranges.

    Built by ``PackedArena.shard``. Rank r owns global posting lists
    ``[list_bounds[r], list_bounds[r+1])`` and therefore global packed rows
    ``[row_bounds[r], row_bounds[r+1])`` — the sharded planner routes each
    work unit to ``owner_of_list(unit.glist)`` and the compressed path's
    re-rank uses ``owner_of_row`` to hand every rank exactly the candidate
    rows it stores. An empty range is a rank with no data, which executes as
    fully-masked padding. ``rank(r)`` is rank r's ``ArenaShard`` on
    ``devices[r]``.
    """

    base: PackedArena
    list_bounds: np.ndarray  # i64 [R + 1] — global posting-list split
    row_bounds: np.ndarray  # i64 [R + 1] — global packed-row split
    devices: Optional[List[torch.device]] = None  # per rank; default the base's

    def __post_init__(self):
        if self.devices is None:
            self.devices = [self.base.device] * self.n_shards
        assert len(self.devices) == self.n_shards, (len(self.devices), self.n_shards)
        self.devices = [torch.device(d) for d in self.devices]
        self._ranks: List[Optional[ArenaShard]] = [None] * self.n_shards

    @property
    def n_shards(self) -> int:
        return len(self.list_bounds) - 1

    @property
    def rows_per_shard(self) -> np.ndarray:
        return np.diff(self.row_bounds)

    def owner_of_list(self, glists: np.ndarray) -> np.ndarray:
        """Owning rank per global list id (duplicate bounds = empty shards)."""
        return np.searchsorted(self.list_bounds, glists, side="right") - 1

    def owner_of_row(self, rows: np.ndarray) -> np.ndarray:
        """Owning rank per global packed row."""
        return np.searchsorted(self.row_bounds, rows, side="right") - 1

    def rank(self, r: int) -> ArenaShard:
        if self._ranks[r] is None:
            self._ranks[r] = ArenaShard(
                self.base, int(self.row_bounds[r]), int(self.row_bounds[r + 1]), self.devices[r]
            )
        return self._ranks[r]
