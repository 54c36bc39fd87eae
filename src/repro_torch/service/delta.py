"""DeltaStore — the freshness layer: live inserts, tombstone deletes, refresh.

The main ``HQIIndex`` is a build-time artifact; a serving system cannot
rebuild it per write. The DeltaStore makes writes visible immediately:

  * **inserts** append to a small side buffer (schema checked against the
    base DB; omitted columns become NULL). The buffer's vectors (and, with a
    codebook, their PQ codes) also live on the index's device, appended per
    insert, so a flush uploads none of them. Every flush brute-force scans
    the buffer's live rows with the same fused masked-top-k kernel the
    engine uses (``kernels.ops.workunit_topk``, one dispatch per flush with
    one work unit per template) and the service folds those candidates into
    the final ``merge_topk`` — so answers always reflect the live DB.
  * **deletes** are tombstones: delta rows are dropped from the scan, indexed
    rows are excluded through the ``live_mask`` the service passes to
    ``HQIIndex.search``. Either way exact, no over-fetch heuristics.
  * **refresh()** (driven by the service) folds the buffer into the main
    index via ``HQIIndex.extend`` — qd-tree leaf routing by semantic
    description, incremental IVF append, incremental arena rebuild — and
    clears the buffer. Global ids are stable: delta row ids continue the
    index's row numbering, so a fold changes *where* a tuple lives, never its
    id. Tombstoned delta rows are folded too (as dead rows under the live
    mask) to keep ids dense.

Compressed delta scans: when the store carries the index's ``PQCodebook``
(the serving layer passes ``HQIIndex.pq``) and the live buffer has outgrown
``ServiceConfig.delta_pq_threshold``, the flush scan switches to the same
two-stage path the engine uses — rows are PQ-encoded once at insert time on
the device, the scan reads uint8 codes through ``kernels.ops.
workunit_pq_topk`` (ADC over expanded per-slot LUTs), and the
``refine_factor · k`` survivors are re-scored exactly from the f32 rows in
one ``workunit_topk`` dispatch. Buffers under the threshold keep the exact
f32 scan.

Both scans build their operands on the device, equal on every live slot to
the host arrays ``repro.service.delta`` builds, and pass ``n_live`` — each
unit's query count, and 1 / 0 on the re-rank's real / padding units — so
padding slots are never scored.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core import kmeans as km
from ..core.ivf import ScanStats
from ..core.plan import _next_pow2
from ..core.pq import PQCodebook, adc_tables, encode_pq_tensor
from ..core.predicates import evaluate_filter
from ..core.types import CATEGORICAL, Column, NUMERIC, SETCAT, VectorDatabase, Workload
from ..fault.failpoints import failpoint
from ..kernels import ops as kops


class DeltaStore:
    """Append buffer + tombstones over a base schema; ids start at first_id.

    The buffered vectors are kept on ``device`` as well (the scans' rows).
    With ``pq`` set (the index codebook), inserted rows are additionally
    PQ-encoded on arrival on ``device`` — one ``encode_pq`` per insert batch
    — so a compressed flush scan never re-encodes the whole buffer.
    """

    def __init__(
        self,
        schema_db: VectorDatabase,
        first_id: int,
        pq: Optional[PQCodebook] = None,
        device: km.Device = "cuda",
    ) -> None:
        self._schema = schema_db  # schema donor only; rows never touched
        self.first_id = int(first_id)
        self.pq = pq
        self.device = torch.device(device)
        self._db: Optional[VectorDatabase] = None
        self._dead = np.zeros(0, dtype=bool)
        self._vectors: Optional[torch.Tensor] = None  # f32 [n, d] on device
        self._codes: Optional[torch.Tensor] = None  # uint8 [n, M] on device, iff pq
        # rows prepared (ids handed out) but not yet committed — group-commit
        # inserts prepare under the service lock, then commit in id order
        # after the shared fsync, so id assignment must advance at prepare
        self._reserved = 0

    @property
    def n(self) -> int:
        """Buffered rows, dead included (ids first_id .. first_id + n - 1)."""
        return 0 if self._db is None else self._db.n

    @property
    def n_live(self) -> int:
        return int((~self._dead).sum())

    # ---------------------------------------------------------------- writes

    def _make_columns(
        self,
        n: int,
        columns: Optional[Dict[str, np.ndarray]],
        null_masks: Optional[Dict[str, np.ndarray]],
    ) -> Dict[str, Column]:
        columns = columns or {}
        null_masks = null_masks or {}
        unknown = set(columns) - set(self._schema.columns)
        assert not unknown, f"insert references unknown columns {sorted(unknown)}"
        out: Dict[str, Column] = {}
        for name, ref in self._schema.columns.items():
            if name not in columns:
                out[name] = Column.all_null(ref, n)
                continue
            vals = columns[name]
            nm = null_masks.get(name)
            if ref.kind == NUMERIC:
                out[name] = Column.numeric(name, vals, null_mask=nm)
            elif ref.kind == CATEGORICAL:
                out[name] = Column.categorical(name, vals, null_mask=nm)
            else:
                assert ref.kind == SETCAT
                out[name] = Column.setcat(name, vals)
            assert out[name].n == n, f"column {name}: {out[name].n} rows, expected {n}"
        return out

    def prepare_insert(
        self,
        vectors: np.ndarray,
        columns: Optional[Dict[str, np.ndarray]] = None,
        null_masks: Optional[Dict[str, np.ndarray]] = None,
    ) -> Tuple[VectorDatabase, np.ndarray]:
        """Validate + stage an insert WITHOUT applying it: (slab, ids).

        Split from ``insert`` for the WAL ordering in service.py: the commit
        record must hit disk after validation (a rejected insert is never
        logged) but before the buffer mutates (a failed append leaves no
        unlogged rows behind). ``commit_insert`` is infallible.
        """
        vectors = np.atleast_2d(np.asarray(vectors, dtype=np.float32))
        assert vectors.shape[1] == self._schema.d, "vector dimension mismatch"
        n = vectors.shape[0]
        ids = self.first_id + self.n + self._reserved + np.arange(n, dtype=np.int64)
        self._reserved += n
        slab = VectorDatabase(
            vectors=vectors,
            columns=self._make_columns(n, columns, null_masks),
            metric=self._schema.metric,
            ids=ids,
        )
        return slab, ids

    def abort_insert(self, ids: np.ndarray) -> None:
        """Release a prepared-but-unlogged insert's id reservation.

        ONLY legal when the prepared slab never reached the WAL (stage
        failed) and no later prepare has happened — prepare and stage share
        one critical section in service.py, so the aborted ids are always the
        reservation's tail and handing them to the next insert is safe.
        """
        n = len(np.atleast_1d(ids))
        assert self._reserved >= n, "abort_insert without matching prepare"
        expect = self.first_id + self.n + self._reserved - n
        assert n == 0 or int(np.atleast_1d(ids)[0]) == expect, (
            "abort_insert out of order — only the newest reservation may abort"
        )
        self._reserved -= n

    def commit_insert(self, slab: VectorDatabase, ids: np.ndarray) -> np.ndarray:
        """Apply a prepared insert (no validation — see ``prepare_insert``).

        Prepared slabs MUST commit in id order (the service's group-commit
        path tickets them): rows concatenate, so first_id + position = id.
        The device copies are replaced, never written in place, so a view
        taken before this call keeps its rows.
        """
        failpoint("delta.apply")
        n = slab.n
        assert n == 0 or self.first_id + self.n == int(ids[0]), (
            "commit_insert out of id order"
        )
        self._reserved = max(0, self._reserved - n)
        new_vec = km.as_tensor(slab.vectors, self.device)
        new_codes = None
        if self.pq is not None:
            new_codes = encode_pq_tensor(self.pq, slab.vectors, device=self.device)
        self._db = slab if self._db is None else VectorDatabase.concat(self._db, slab)
        self._dead = np.concatenate([self._dead, np.zeros(n, dtype=bool)])
        self._vectors = new_vec if self._vectors is None else torch.cat([self._vectors, new_vec])
        if new_codes is not None:
            self._codes = (
                new_codes if self._codes is None else torch.cat([self._codes, new_codes])
            )
        return ids

    def insert(
        self,
        vectors: np.ndarray,
        columns: Optional[Dict[str, np.ndarray]] = None,
        null_masks: Optional[Dict[str, np.ndarray]] = None,
    ) -> np.ndarray:
        """Append rows; returns their global ids (visible to the next flush)."""
        slab, ids = self.prepare_insert(vectors, columns, null_masks)
        return self.commit_insert(slab, ids)

    def delete(self, ext_id: int) -> bool:
        """Tombstone a buffered row; False if the id is not in the buffer."""
        local = int(ext_id) - self.first_id
        if 0 <= local < self.n and not self._dead[local]:
            self._dead[local] = True
            return True
        return False

    # ----------------------------------------------------------------- reads

    def view(self) -> "DeltaView":
        """Immutable scan snapshot (db slab, device rows, live mask, id base).

        The lock-free flush path captures this under the service lock and
        scans OUTSIDE it: the slab and the device tensors are replaced (never
        mutated) by ``insert`` and the live mask is copied here, so a
        concurrent writer can't shift the snapshot under the scan.
        """
        return DeltaView(
            db=self._db,
            live=~self._dead.copy(),
            first_id=self.first_id,
            pq=self.pq,
            codes=self._codes,
            vectors=self._vectors,
        )

    def scan(
        self,
        workload: Workload,
        *,
        stats: Optional[ScanStats] = None,
        pq_threshold: Optional[int] = None,
        refine_factor: int = 4,
    ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """Brute-force top-k over live buffered rows, per query (see
        ``DeltaView.scan``)."""
        return self.view().scan(
            workload,
            stats=stats,
            pq_threshold=pq_threshold,
            refine_factor=refine_factor,
        )

    # --------------------------------------------------------------- refresh

    def snapshot(self) -> Tuple[Optional[VectorDatabase], np.ndarray]:
        """(buffered rows incl. tombstoned, live mask) — the refresh fold input."""
        return self._db, ~self._dead.copy()

    def clear(self, first_id: int) -> None:
        """Reset after a fold; subsequent inserts continue from ``first_id``."""
        self._db = None
        self._dead = np.zeros(0, dtype=bool)
        self._vectors = None
        self._codes = None
        self._reserved = 0
        self.first_id = int(first_id)


@dataclasses.dataclass
class DeltaView:
    """A consistent point-in-time scan view of the buffer (see ``view()``)."""

    db: Optional[VectorDatabase]
    live: np.ndarray  # bool — alive among the snapshot's buffered rows
    first_id: int
    pq: Optional[PQCodebook] = None  # index codebook (compressed scans)
    codes: Optional[torch.Tensor] = None  # uint8 [n, M] on the device, row-aligned with db
    vectors: Optional[torch.Tensor] = None  # f32 [n, d] on the device, row-aligned with db

    def scan(
        self,
        workload: Workload,
        *,
        stats: Optional[ScanStats] = None,
        pq_threshold: Optional[int] = None,
        refine_factor: int = 4,
    ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """Top-k over the snapshot's live rows, per query.

        Returns (scores f32 [m, k], global ids i64 [m, k]), tensors on the
        view's device, best-first with (-inf, -1) padding, or None when no
        buffered row passes any filter.
        Exact brute force by default. When the view carries the index
        codebook and the live buffer exceeds ``pq_threshold``, the scan runs
        compressed instead: one ADC dispatch over the uint8 codes keeping
        ``refine_factor · k`` candidates per query, then one exact f32
        re-rank dispatch of the survivors — M bytes scanned per row instead
        of d·4. Buffers at or under the threshold stay exact.
        """
        db = self.db
        if db is None or not self.live.any():
            return None
        groups = self._groups(workload, stats)
        if not groups:
            return None
        use_pq = (
            self.pq is not None
            and self.codes is not None
            and pq_threshold is not None
            and int(self.live.sum()) > int(pq_threshold)
        )
        if use_pq:
            return self._scan_pq(workload, groups, refine_factor, stats)
        return self._scan_f32(workload, groups, stats)

    def _groups(
        self, workload: Workload, stats: Optional[ScanStats]
    ) -> list:
        """Per-template (query rows, filtered live bitmap) scan groups."""
        db = self.db
        groups = []  # (qidx, bitmap over buffered rows)
        for ti, filt in enumerate(workload.templates):
            qidx = workload.queries_for_template(ti)
            if len(qidx) == 0:
                continue
            bm = evaluate_filter(filt, db) & self.live
            if stats is not None:
                stats.tuples_scanned += db.n * len(qidx)
                stats.dists_computed += int(bm.sum()) * len(qidx)
            if bm.any():
                groups.append((qidx, bm))
        return groups

    def _unit_operands(self, groups: list, tv: int):
        """What both scans share: one unit per group, its queries in slots
        0 … n-1. Returns (qrow i64 [W, TQ] on the device, -1 on padding
        slots; valid bool [W, TV], the group bitmaps padded with False;
        n_live i32 [W], the group sizes)."""
        dev = self.vectors.device
        n = self.db.n
        W = len(groups)
        TQ = _next_pow2(max(len(q) for q, _ in groups), 1)
        qrow = np.full((W, TQ), -1, dtype=np.int64)
        valid = np.zeros((W, tv), dtype=bool)
        for w, (qidx, bm) in enumerate(groups):
            qrow[w, : len(qidx)] = qidx
            valid[w, :n] = bm
        n_live = np.array([len(q) for q, _ in groups], dtype=np.int32)
        return (torch.from_numpy(qrow).to(dev), torch.from_numpy(valid).to(dev),
                torch.from_numpy(n_live).to(dev))

    def _padded_rows(self, rows: torch.Tensor, w: int, tv: int) -> torch.Tensor:
        """``rows`` [n, ...] zero-padded to ``tv`` rows and repeated for ``w``
        units: [w, tv, ...], contiguous (the kernels take no broadcast)."""
        out = torch.zeros((tv,) + tuple(rows.shape[1:]), dtype=rows.dtype, device=rows.device)
        out[: rows.shape[0]] = rows
        return out.expand((w,) + tuple(out.shape)).contiguous()

    def _scatter(self, m: int, k: int, qrow: torch.Tensor, s: torch.Tensor, ids: torch.Tensor):
        """Per-unit slot results [W, TQ, kk] -> per-query [m, k] tensors
        (best-first, (-inf, -1) where absent)."""
        dev = s.device
        live = qrow >= 0
        kk = s.shape[-1]
        out_s = torch.full((m, k), -float("inf"), dtype=torch.float32, device=dev)
        out_i = torch.full((m, k), -1, dtype=torch.int64, device=dev)
        out_s[qrow[live], :kk] = s[live]
        out_i[qrow[live], :kk] = ids[live]
        return torch.where(out_i < 0, -float("inf"), out_s), out_i

    def _scan_f32(
        self,
        workload: Workload,
        groups: list,
        stats: Optional[ScanStats],
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The exact path: one fused f32 work-unit dispatch per flush."""
        db = self.db
        k, m, d = workload.k, workload.m, db.d
        dev = self.vectors.device
        TV = _next_pow2(db.n, 8)
        qrow, valid, n_live = self._unit_operands(groups, TV)
        W, TQ = qrow.shape
        q_dev = km.as_tensor(workload.vectors, dev)
        Q = torch.zeros((W, TQ, d), dtype=torch.float32, device=dev)
        Q[qrow >= 0] = q_dev[qrow[qrow >= 0]]
        V = self._padded_rows(self.vectors, W, TV)
        if stats is not None:
            stats.bytes_scanned += W * db.n * d * 4
        kk = min(k, TV)
        s, iloc = kops.workunit_topk(Q, V, valid, kk, metric=db.metric, n_live=n_live)
        iloc = iloc.to(torch.int64)
        ids = torch.where(iloc >= 0, self.first_id + iloc, -1)
        return self._scatter(m, k, qrow, s, ids)

    def _scan_pq(
        self,
        workload: Workload,
        groups: list,
        refine_factor: int,
        stats: Optional[ScanStats],
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Compressed path: ADC over uint8 codes, exact re-rank of survivors.

        Mirrors the engine's two-stage ``scan_mode="pq"`` execution
        (core/planner.py): stage A is one ``workunit_pq_topk`` dispatch over
        the buffer's code rows (one work unit per flush template, the
        flush's LUTs built once on the host and expanded into the units on
        the device), stage B gathers the surviving rows' f32 vectors and
        re-scores them exactly in one per-query ``workunit_topk`` dispatch —
        so returned scores are exact and directly mergeable with the
        engine's (exact) results.
        """
        db = self.db
        k, m, d = workload.k, workload.m, db.d
        dev = self.vectors.device
        M = self.codes.shape[1]
        TV = _next_pow2(db.n, 8)
        kprime = min(max(k, int(refine_factor) * k), TV)
        qrow, valid, n_live = self._unit_operands(groups, TV)
        W, TQ = qrow.shape
        live = qrow >= 0

        luts_all = torch.from_numpy(adc_tables(self.pq, workload.vectors)).to(dev)
        luts = torch.zeros((W, TQ, M, luts_all.shape[2]), dtype=torch.float32, device=dev)
        luts[live] = luts_all[qrow[live]]
        codes = self._padded_rows(self.codes, W, TV)
        if stats is not None:
            stats.bytes_scanned += W * db.n * M
        _, iloc = kops.workunit_pq_topk(luts, codes, valid, kprime, n_live=n_live)

        # per-query survivor rows (each query scans exactly one group)
        rows = torch.full((m, kprime), -1, dtype=torch.int64, device=dev)
        rows[qrow[live]] = iloc[live].to(torch.int64)

        # exact re-rank: one per-query-unit dispatch over the survivors; the
        # power-of-two padding units hold no query (n_live 0)
        mp = _next_pow2(m, 1)
        Qr = torch.zeros((mp, 1, d), dtype=torch.float32, device=dev)
        Qr[:m, 0] = km.as_tensor(workload.vectors, dev)
        rows_p = torch.full((mp, kprime), -1, dtype=torch.int64, device=dev)
        rows_p[:m] = rows
        valid_r = rows_p >= 0
        Vr = self.vectors.index_select(0, rows_p.clamp(min=0).reshape(-1)).reshape(mp, kprime, d)
        n_live_r = (torch.arange(mp, device=dev) < m).to(torch.int32)
        if stats is not None:
            stats.bytes_scanned += int(valid_r.sum()) * d * 4
        kk = min(k, kprime)
        s, i_loc = kops.workunit_topk(Qr, Vr, valid_r, kk, metric=db.metric, n_live=n_live_r)
        s = s[:m, 0]  # [m, kk] exact scores
        i_loc = i_loc[:m, 0].to(torch.int64)  # index into the survivors
        picked = torch.gather(rows, 1, i_loc.clamp(min=0))
        out_i = torch.full((m, k), -1, dtype=torch.int64, device=dev)
        out_s = torch.full((m, k), -float("inf"), dtype=torch.float32, device=dev)
        out_i[:, :kk] = torch.where(i_loc >= 0, self.first_id + picked, -1)
        out_s[:, :kk] = torch.where(i_loc >= 0, s, -float("inf"))
        return torch.where(out_i < 0, -float("inf"), out_s), out_i
