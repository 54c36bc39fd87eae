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
from the same arena. Sharding the arena waits for the sharded engine
(ROADMAP.md §1, sharded engine).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import kmeans as km
from .ivf import IVFIndex
from .pq import PQCodebook, encode_pq_tensor


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

    def to_state(self) -> dict:
        """The reference's arena state: every array a numpy leaf."""
        return {
            "metric": self.metric,
            "packed": self.packed.cpu().numpy(),
            "gid": self.gid.cpu().numpy(),
            "local_of": self.local_of,
            "list_start": self.list_start,
            "list_len": self.list_len,
            "list_base": self.list_base,
            "part_row": self.part_row,
            "centroids": {str(p): c for p, c in enumerate(self.centroids)},
            "pq": None if self.pq is None else self.pq.to_state(),
            "codes": None if self.codes is None else self.codes.cpu().numpy(),
        }

    @staticmethod
    def from_state(state: dict, device: km.Device = "cuda") -> "PackedArena":
        cents = state["centroids"]
        return PackedArena(
            packed=km.as_tensor(np.asarray(state["packed"]), device),
            gid=torch.from_numpy(np.asarray(state["gid"], dtype=np.int64)).to(device),
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
