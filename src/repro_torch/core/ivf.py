"""Clustering-based IVF index with contiguous posting lists and bitmap pushdown.

The index stores vectors re-ordered so that every posting list is a dense,
contiguous slice (accelerator adaptation: scans become dense tiles instead of pointer
chases). ``search_group`` is the host-side multi-query scan the adaptive executor
(``batch_vec=False`` / ``"auto"``) takes, ``search_single`` the per-query one of the
baselines (numpy/BLAS — a stand-in for FAISS's per-query IVF scan incl. its
IDSelector bitmap pushdown). k-means training,
assignment and probing run on the index's ``device``. Batched execution
(Algorithm 3) lives in planner.py.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np

from . import kmeans as km
from .types import METRIC_IP, METRIC_L2


@dataclasses.dataclass
class ScanStats:
    tuples_scanned: int = 0  # posting-list entries touched
    dists_computed: int = 0  # distance computations after bitmap skip
    # bytes the engine's scan stages gathered from arena storage (f32 vector
    # tiles, or uint8 code tiles + re-rank rows in scan_mode="pq") — the HBM
    # traffic the compressed path exists to cut; engine path only
    bytes_scanned: int = 0
    # largest candidate merge buffer (scores + ids) any single execution
    # allocated — m·n_slots·k-shaped under merge_layout="dense", Σ segments·k
    # under "segmented"; the quantity the skewed-routing bench compares
    peak_candidate_bytes: int = 0
    # ADC LUT bytes materialized on device: the resident [U, M, 256] table
    # once per pq execution, plus (dense layout only) every per-bucket
    # [W, TQ, M, 256] expansion — segmented keeps this at the resident size
    lut_bytes: int = 0

    def __iadd__(self, o: "ScanStats"):
        self.tuples_scanned += o.tuples_scanned
        self.dists_computed += o.dists_computed
        self.bytes_scanned += o.bytes_scanned
        self.peak_candidate_bytes = max(self.peak_candidate_bytes, o.peak_candidate_bytes)
        self.lut_bytes += o.lut_bytes
        return self


@dataclasses.dataclass
class IVFIndex:
    centroids: np.ndarray  # [nc, d]
    packed: np.ndarray  # [n, d] vectors re-ordered by posting list
    order: np.ndarray  # [n] packed row -> local vector index
    offsets: np.ndarray  # [nc + 1] list boundaries in packed order
    metric: str
    device: km.Device = dataclasses.field(default="cuda", compare=False)

    @property
    def n(self) -> int:
        return int(self.packed.shape[0])

    @property
    def n_lists(self) -> int:
        return int(self.centroids.shape[0])

    def list_len(self, l: int) -> int:
        return int(self.offsets[l + 1] - self.offsets[l])

    @staticmethod
    def build(
        vectors: np.ndarray,
        *,
        metric: str = METRIC_IP,
        n_centroids: Optional[int] = None,
        kmeans_iters: int = 8,
        seed: int = 0,
        device: km.Device = "cuda",
    ) -> "IVFIndex":
        n = vectors.shape[0]
        if n_centroids is None:
            # FAISS-style sqrt(n), rounded to a power of two so the jit'd
            # k-means update specializes on O(log n) distinct shapes across
            # the many per-partition indexes
            k0 = max(1, int(math.isqrt(n)))
            n_centroids = 1 << (k0 - 1).bit_length()
        n_centroids = min(n_centroids, n)
        cents = km.train_kmeans(
            vectors, n_centroids, iters=kmeans_iters, metric=metric, seed=seed, device=device
        )
        assign = km.assign_kmeans(vectors, cents, metric=metric, device=device)
        order = np.argsort(assign, kind="stable").astype(np.int64)
        sorted_assign = assign[order]
        offsets = np.zeros(len(cents) + 1, dtype=np.int64)
        counts = np.bincount(sorted_assign, minlength=len(cents))
        offsets[1:] = np.cumsum(counts)
        return IVFIndex(
            centroids=cents,
            packed=np.ascontiguousarray(vectors[order]),
            order=order,
            offsets=offsets,
            metric=metric,
            device=device,
        )

    def to_state(self) -> dict:
        """Snapshot state (store/snapshot.py): arrays stay np.ndarray leaves."""
        return {
            "metric": self.metric,
            "centroids": self.centroids,
            "packed": self.packed,
            "order": self.order,
            "offsets": self.offsets,
        }

    @staticmethod
    def from_state(state: dict, device: km.Device = "cuda") -> "IVFIndex":
        return IVFIndex(
            centroids=np.asarray(state["centroids"]),
            packed=np.asarray(state["packed"]),
            order=np.asarray(state["order"]),
            offsets=np.asarray(state["offsets"]),
            metric=state["metric"],
            device=device,
        )

    def extend(self, vectors: np.ndarray) -> "IVFIndex":
        """New index with ``vectors`` appended to the existing posting lists.

        The incremental-insert path of the serving layer's ``refresh()``: the
        quantizer (centroids) is kept, each new vector is assigned to its
        nearest existing list on the index's device, and the packed layout is
        re-sorted (stably) so lists stay contiguous. New vectors get local
        indices ``n .. n+len-1`` (the caller appends their ids to its row
        table in the same order). O(n + new) repacking, no k-means.
        """
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        if vectors.shape[0] == 0:
            return self
        assign_new = km.assign_kmeans(
            vectors, self.centroids, metric=self.metric, device=self.device
        )
        list_of_packed = np.repeat(
            np.arange(self.n_lists, dtype=np.int64), np.diff(self.offsets)
        )
        all_list = np.concatenate([list_of_packed, assign_new.astype(np.int64)])
        all_local = np.concatenate(
            [self.order, self.n + np.arange(vectors.shape[0], dtype=np.int64)]
        )
        all_vecs = np.concatenate([self.packed, vectors], axis=0)
        sort = np.argsort(all_list, kind="stable")
        counts = np.bincount(all_list, minlength=self.n_lists)
        offsets = np.zeros(self.n_lists + 1, dtype=np.int64)
        offsets[1:] = np.cumsum(counts)
        return IVFIndex(
            centroids=self.centroids,
            packed=np.ascontiguousarray(all_vecs[sort]),
            order=all_local[sort],
            offsets=offsets,
            metric=self.metric,
            device=self.device,
        )

    # -- coarse quantizer ----------------------------------------------------

    def probe(self, q_vecs: np.ndarray, nprobe: int) -> np.ndarray:
        """nprobe nearest posting lists per query: int32 [m, nprobe]."""
        nprobe = int(min(nprobe, self.n_lists))
        return km.topm_centroids(
            q_vecs, self.centroids, nprobe, metric=self.metric, device=self.device
        )

    # -- online (per-query) scan ----------------------------------------------

    def search_single(
        self,
        q: np.ndarray,  # [d]
        *,
        nprobe: int,
        k: int,
        bitmap: Optional[np.ndarray] = None,  # bool [n] in LOCAL vector order
        stats: Optional[ScanStats] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k (scores f32 [k] desc, local idx i64 [k]) of one query: the
        FAISS-like per-query path the baselines take, ``search_group`` for a
        group of one."""
        s, i = self.search_group(q[None, :], nprobe=nprobe, k=k, bitmap=bitmap, stats=stats)
        return s[0], i[0]

    def search_group(
        self,
        q_vecs: np.ndarray,  # [mq, d]
        *,
        nprobe: int,
        k: int,
        bitmap: Optional[np.ndarray] = None,  # bool [n] in LOCAL vector order
        stats: Optional[ScanStats] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Multi-query host-side scan (the reference's per-query scan for a
        query group): each probed posting list is gathered and bitmap-filtered
        ONCE for every group member probing it, and their distances come from
        one shared GEMM (``block @ Qᵀ``). This is what makes the
        serving layer's micro-batches pay even on the adaptive executor's
        host path: queries of one template probing overlapping lists share
        the scan. Returns (scores f32 [mq, k] desc, local idx i64 [mq, k]).
        """
        mq = q_vecs.shape[0]
        out_s = np.full((mq, k), -np.inf, np.float32)
        out_i = np.full((mq, k), -1, np.int64)
        if mq == 0:
            return out_s, out_i
        probes = self.probe(q_vecs, nprobe)  # [mq, np_eff]
        np_eff = probes.shape[1]
        flat_l = probes.reshape(-1).astype(np.int64)
        flat_q = np.repeat(np.arange(mq, dtype=np.int64), np_eff)
        order = np.argsort(flat_l, kind="stable")
        flat_l, flat_q = flat_l[order], flat_q[order]
        uniq, starts = np.unique(flat_l, return_index=True)
        ends = np.append(starts[1:], len(flat_l))
        cand_s: list = [[] for _ in range(mq)]
        cand_i: list = [[] for _ in range(mq)]
        qn = (q_vecs * q_vecs).sum(axis=1) if self.metric == METRIC_L2 else None
        for l, g0, g1 in zip(uniq, starts, ends):
            s, e = int(self.offsets[l]), int(self.offsets[l + 1])
            if e == s:
                continue
            qs = flat_q[g0:g1]
            members = self.order[s:e]
            if stats is not None:
                stats.tuples_scanned += (e - s) * len(qs)
            if bitmap is not None:
                sel = bitmap[members]
                if not sel.any():
                    continue
                members = members[sel]
                block = self.packed[s:e][sel]
            else:
                block = self.packed[s:e]
            if stats is not None:
                stats.dists_computed += block.shape[0] * len(qs)
            ip = block @ q_vecs[qs].T  # [n_block, |qs|] — one GEMM per list
            if self.metric == METRIC_L2:
                sc = 2.0 * ip - (block * block).sum(axis=1)[:, None] - qn[qs][None, :]
            else:
                sc = ip
            for col, qi in enumerate(qs):
                cand_s[qi].append(sc[:, col])
                cand_i[qi].append(members)
        for qi in range(mq):
            if not cand_s[qi]:
                continue
            sc = np.concatenate(cand_s[qi])
            ix = np.concatenate(cand_i[qi])
            kk = min(k, len(sc))
            top = np.argpartition(-sc, kk - 1)[:kk]
            top = top[np.argsort(-sc[top], kind="stable")]
            out_s[qi, :kk] = sc[top]
            out_i[qi, :kk] = ix[top]
        return out_s, out_i
