"""Core data model for HQI: vector database, attributes, queries, workloads.

The vector database V is a set of tuples t = (id, e, a) — Definition 1 in the
paper. Attributes are columnar and typed; NULLs are first-class (the paper's
workloads lean heavily on IS NOT NULL checks). Everything host-side is numpy;
device-side compute (distance kernels, k-means) lives in PyTorch under
``repro_torch.kernels`` / ``repro_torch.core.kmeans``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Columns
# ---------------------------------------------------------------------------

NUMERIC = "numeric"
CATEGORICAL = "categorical"
SETCAT = "setcat"  # set-valued categorical, e.g. entity "type" with many tags


@dataclasses.dataclass
class Column:
    """One attribute column.

    kind == NUMERIC:     values float32[n]; null_mask bool[n]
    kind == CATEGORICAL: values int32[n] (code), null_mask bool[n]
    kind == SETCAT:      values bool[n, cardinality] membership matrix;
                         null_mask bool[n] (empty set == NULL)
    """

    name: str
    kind: str
    values: np.ndarray
    null_mask: np.ndarray

    def __post_init__(self):
        if self.kind not in (NUMERIC, CATEGORICAL, SETCAT):
            raise ValueError(f"unknown column kind {self.kind!r}")
        n = self.values.shape[0]
        assert self.null_mask.shape == (n,), "null_mask must be [n]"

    @property
    def n(self) -> int:
        return int(self.values.shape[0])

    def take(self, idx: np.ndarray) -> "Column":
        return Column(self.name, self.kind, self.values[idx], self.null_mask[idx])

    @staticmethod
    def numeric(name: str, values: np.ndarray, null_mask: Optional[np.ndarray] = None) -> "Column":
        values = np.asarray(values, dtype=np.float32)
        if null_mask is None:
            null_mask = np.zeros(values.shape[0], dtype=bool)
        return Column(name, NUMERIC, values, np.asarray(null_mask, dtype=bool))

    @staticmethod
    def categorical(name: str, codes: np.ndarray, null_mask: Optional[np.ndarray] = None) -> "Column":
        codes = np.asarray(codes, dtype=np.int32)
        if null_mask is None:
            null_mask = codes < 0
        return Column(name, CATEGORICAL, codes, np.asarray(null_mask, dtype=bool))

    @staticmethod
    def setcat(name: str, membership: np.ndarray) -> "Column":
        membership = np.asarray(membership, dtype=bool)
        null_mask = ~membership.any(axis=1)
        return Column(name, SETCAT, membership, null_mask)

    @staticmethod
    def concat(a: "Column", b: "Column") -> "Column":
        """Row-wise concatenation (schema must match) — the live-insert path."""
        assert a.kind == b.kind and a.name == b.name, (a.name, b.name)
        if a.kind == SETCAT:
            assert a.values.shape[1] == b.values.shape[1], "setcat cardinality"
        values = np.concatenate([a.values, b.values], axis=0)
        return Column(a.name, a.kind, values, np.concatenate([a.null_mask, b.null_mask]))

    def to_state(self) -> dict:
        """Snapshot state (store/snapshot.py): arrays stay np.ndarray leaves."""
        return {
            "name": self.name,
            "kind": self.kind,
            "values": self.values,
            "null_mask": self.null_mask,
        }

    @staticmethod
    def from_state(state: dict) -> "Column":
        return Column(
            name=state["name"],
            kind=state["kind"],
            values=np.asarray(state["values"]),
            null_mask=np.asarray(state["null_mask"]),
        )

    @staticmethod
    def all_null(like: "Column", n: int) -> "Column":
        """n rows of NULL with ``like``'s schema (inserts omitting a column)."""
        if like.kind == SETCAT:
            values = np.zeros((n, like.values.shape[1]), dtype=bool)
        elif like.kind == CATEGORICAL:
            values = np.full(n, -1, dtype=np.int32)
        else:
            values = np.zeros(n, dtype=np.float32)
        return Column(like.name, like.kind, values, np.ones(n, dtype=bool))


# ---------------------------------------------------------------------------
# Vector database
# ---------------------------------------------------------------------------

METRIC_L2 = "l2"
METRIC_IP = "ip"


@dataclasses.dataclass
class VectorDatabase:
    """V: n tuples of (id, e: float32[d], a: columns)."""

    vectors: np.ndarray  # float32 [n, d]
    columns: Dict[str, Column]
    metric: str = METRIC_IP
    ids: Optional[np.ndarray] = None  # int64 [n]; defaults to arange

    def __post_init__(self):
        self.vectors = np.ascontiguousarray(self.vectors, dtype=np.float32)
        if self.ids is None:
            self.ids = np.arange(self.n, dtype=np.int64)
        for c in self.columns.values():
            assert c.n == self.n, f"column {c.name} has {c.n} rows, expected {self.n}"
        if self.metric not in (METRIC_L2, METRIC_IP):
            raise ValueError(f"unknown metric {self.metric!r}")

    @property
    def n(self) -> int:
        return int(self.vectors.shape[0])

    @property
    def d(self) -> int:
        return int(self.vectors.shape[1])

    def take(self, idx: np.ndarray) -> "VectorDatabase":
        return VectorDatabase(
            vectors=self.vectors[idx],
            columns={k: c.take(idx) for k, c in self.columns.items()},
            metric=self.metric,
            ids=self.ids[idx],
        )

    def to_state(self) -> dict:
        """Snapshot state (store/snapshot.py): arrays stay np.ndarray leaves."""
        return {
            "metric": self.metric,
            "vectors": self.vectors,
            "ids": self.ids,
            "columns": {name: c.to_state() for name, c in self.columns.items()},
        }

    @staticmethod
    def from_state(state: dict) -> "VectorDatabase":
        return VectorDatabase(
            vectors=np.asarray(state["vectors"]),
            columns={
                name: Column.from_state(cs) for name, cs in state["columns"].items()
            },
            metric=state["metric"],
            ids=np.asarray(state["ids"]),
        )

    @staticmethod
    def concat(a: "VectorDatabase", b: "VectorDatabase") -> "VectorDatabase":
        """Row-wise concatenation of two same-schema databases (live inserts)."""
        assert a.metric == b.metric, "mixed-metric concat"
        assert set(a.columns) == set(b.columns), "schema mismatch"
        assert a.d == b.d, "dimension mismatch"
        return VectorDatabase(
            vectors=np.concatenate([a.vectors, b.vectors], axis=0),
            columns={k: Column.concat(c, b.columns[k]) for k, c in a.columns.items()},
            metric=a.metric,
            ids=np.concatenate([a.ids, b.ids]),
        )


# ---------------------------------------------------------------------------
# Queries / workload
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HybridQuery:
    """q = (e, f): Definition 2. ``filter`` is a canonical tuple of predicates

    (see predicates.py); the empty tuple means pure vector search.
    """

    vector: np.ndarray  # float32 [d]
    filter: tuple  # tuple of Predicate (hashable, canonical order)


@dataclasses.dataclass
class Workload:
    """A batch HVQ workload: query vectors [m, d] + per-query filter template.

    Filters are interned: ``templates`` is the list of distinct filters and
    ``template_of`` maps each query to its template index. This mirrors the
    paper's observation that a few templates cover most queries (filter
    commonality) and is what Algorithm 3 groups by.
    """

    vectors: np.ndarray  # float32 [m, d]
    templates: List[tuple]  # distinct filters
    template_of: np.ndarray  # int32 [m]
    k: int = 10

    @property
    def m(self) -> int:
        return int(self.vectors.shape[0])

    @staticmethod
    def from_queries(queries: Sequence[HybridQuery], k: int = 10) -> "Workload":
        interned: Dict[tuple, int] = {}
        template_of = np.empty(len(queries), dtype=np.int32)
        vecs = np.stack([q.vector for q in queries]).astype(np.float32)
        for i, q in enumerate(queries):
            if q.filter not in interned:
                interned[q.filter] = len(interned)
            template_of[i] = interned[q.filter]
        templates = [None] * len(interned)
        for f, ti in interned.items():
            templates[ti] = f
        return Workload(vectors=vecs, templates=templates, template_of=template_of, k=k)

    def queries_for_template(self, ti: int) -> np.ndarray:
        return np.nonzero(self.template_of == ti)[0]

    def subset(self, qidx: np.ndarray) -> "Workload":
        used = sorted(set(int(t) for t in self.template_of[qidx]))
        remap = {t: i for i, t in enumerate(used)}
        return Workload(
            vectors=self.vectors[qidx],
            templates=[self.templates[t] for t in used],
            template_of=np.array([remap[int(t)] for t in self.template_of[qidx]], dtype=np.int32),
            k=self.k,
        )


@dataclasses.dataclass
class SearchResult:
    """Top-k results: ids int64 [m, k] (-1 padding), dists float32 [m, k].

    ``dists`` are *scores* ordered best-first: for IP higher-is-better stored
    as the raw inner product; for L2 we store negative squared distance so
    that best-first ordering is uniformly descending.
    """

    ids: np.ndarray
    scores: np.ndarray
    tuples_scanned: int = 0  # distance computations performed (paper metric 2)
    bytes_scanned: int = 0  # arena bytes gathered by the engine's scan stages
    # largest candidate merge buffer one execution allocated (scores + ids):
    # the memory figure the segmented layout exists to shrink
    peak_candidate_bytes: int = 0
    # ADC LUT bytes materialized on device (pq scans only): resident tables,
    # plus per-bucket expansions under merge_layout="dense"
    lut_bytes: int = 0
    # per-rank accounting when the search ran on a device mesh
    # (core.planner.ShardStats; annotated loosely so types stays import-light)
    shard_stats: Optional[object] = None
    # partition id -> number of queries the router sent there (engine tasks
    # plus adaptive per-query scans) — the drift monitor's probe-heat feed
    part_probes: Optional[Dict[int, int]] = None

    @property
    def k(self) -> int:
        return int(self.ids.shape[1])
