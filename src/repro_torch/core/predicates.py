"""Predicates for hybrid queries (Definition 2) and qd-tree cuts.

A hybrid query's attribute constraint is a conjunction f = p1 ∧ … ∧ pk where
each p is one of:

  * ``Cmp(attr, op, x)``       — unary comparison, op ∈ {<, <=, >, >=, ==}
  * ``In(attr, {x1..xj})``     — categorical set membership
  * ``Contains(attr, x)``      — set-valued attribute contains value
                                  (the paper's `'Person' IN V.a['type']`)
  * ``NotNull(attr)``          — existence check
  * ``CentroidIn({c0..cm})``   — derived predicate over the k-means centroid
                                  assignment t.c (Section 4.1.1)

All predicates are frozen/hashable so filters can be interned into templates
and used as qd-tree cut predicates. ``evaluate`` produces the bitmap used for
pushdown (Section 4.2); ``implies`` provides the conservative subsumption test
used for semantic-description routing (Section 4.1.3).
"""
from __future__ import annotations

import dataclasses
from typing import FrozenSet, Tuple

import numpy as np

from .types import CATEGORICAL, NUMERIC, SETCAT, Column, VectorDatabase

_OPS = ("<", "<=", ">", ">=", "==")


@dataclasses.dataclass(frozen=True, order=True)
class Predicate:
    def evaluate(self, db: VectorDatabase, centroid_of: np.ndarray | None = None) -> np.ndarray:
        raise NotImplementedError

    def implies(self, other: "Predicate") -> bool:
        """True if self ⇒ other (every tuple satisfying self satisfies other).

        Conservative: False negatives are allowed, False positives are not.
        """
        return self == other


@dataclasses.dataclass(frozen=True, order=True)
class Cmp(Predicate):
    attr: str
    op: str
    value: float

    def __post_init__(self):
        assert self.op in _OPS, self.op

    def evaluate(self, db, centroid_of=None):
        col = db.columns[self.attr]
        assert col.kind == NUMERIC, f"Cmp on non-numeric column {self.attr}"
        v = col.values
        if self.op == "<":
            out = v < self.value
        elif self.op == "<=":
            out = v <= self.value
        elif self.op == ">":
            out = v > self.value
        elif self.op == ">=":
            out = v >= self.value
        else:
            out = v == self.value
        return out & ~col.null_mask

    def implies(self, other):
        if self == other:
            return True
        if isinstance(other, NotNull) and other.attr == self.attr:
            return True  # a comparison only passes on non-NULL values
        if not isinstance(other, Cmp) or other.attr != self.attr:
            return False
        s, o = self, other
        if o.op == "<":
            return (s.op in ("<", "<=", "==")) and (
                s.value < o.value or (s.op == "<" and s.value == o.value)
            )
        if o.op == "<=":
            return (s.op in ("<", "<=", "==")) and s.value <= o.value
        if o.op == ">":
            return (s.op in (">", ">=", "==")) and (
                s.value > o.value or (s.op == ">" and s.value == o.value)
            )
        if o.op == ">=":
            return (s.op in (">", ">=", "==")) and s.value >= o.value
        if o.op == "==":
            return s.op == "==" and s.value == o.value
        return False


@dataclasses.dataclass(frozen=True, order=True)
class Between(Predicate):
    """lo <= attr < hi — the range predicate used by the synthetic BIGANN-style

    workloads (selectivity 2^-i grids) and by Range partitioning (Strategy C).
    """

    attr: str
    lo: float
    hi: float

    def evaluate(self, db, centroid_of=None):
        col = db.columns[self.attr]
        assert col.kind == NUMERIC
        return (col.values >= self.lo) & (col.values < self.hi) & ~col.null_mask

    def implies(self, other):
        if self == other:
            return True
        if isinstance(other, NotNull) and other.attr == self.attr:
            return True
        if isinstance(other, Between) and other.attr == self.attr:
            return other.lo <= self.lo and self.hi <= other.hi
        if isinstance(other, Cmp) and other.attr == self.attr:
            if other.op in (">=",):
                return self.lo >= other.value
            if other.op in (">",):
                return self.lo > other.value
            if other.op in ("<",):
                return self.hi <= other.value
            if other.op in ("<=",):
                return self.hi <= other.value
        return False


@dataclasses.dataclass(frozen=True, order=True)
class In(Predicate):
    attr: str
    values: FrozenSet[int]

    def evaluate(self, db, centroid_of=None):
        col = db.columns[self.attr]
        assert col.kind == CATEGORICAL, f"In on non-categorical column {self.attr}"
        out = np.isin(col.values, np.fromiter(self.values, dtype=np.int32))
        return out & ~col.null_mask

    def implies(self, other):
        if self == other:
            return True
        if isinstance(other, NotNull) and other.attr == self.attr:
            return True
        if isinstance(other, In) and other.attr == self.attr:
            return self.values <= other.values
        return False


@dataclasses.dataclass(frozen=True, order=True)
class Contains(Predicate):
    attr: str
    value: int  # code of the contained element

    def evaluate(self, db, centroid_of=None):
        col = db.columns[self.attr]
        assert col.kind == SETCAT, f"Contains on non-setcat column {self.attr}"
        return col.values[:, self.value] & ~col.null_mask

    def implies(self, other):
        if self == other:
            return True
        if isinstance(other, NotNull) and other.attr == self.attr:
            return True
        return False


@dataclasses.dataclass(frozen=True, order=True)
class NotNull(Predicate):
    attr: str

    def evaluate(self, db, centroid_of=None):
        return ~db.columns[self.attr].null_mask


@dataclasses.dataclass(frozen=True, order=True)
class CentroidIn(Predicate):
    """t.c ∈ centroids — the vector-similarity constraint transformed into a

    categorical predicate over the k-means assignment (Section 4.1.1).
    Evaluation needs ``centroid_of`` (int32 [n]) which the index provides.
    """

    centroids: FrozenSet[int]

    def evaluate(self, db, centroid_of=None):
        assert centroid_of is not None, "CentroidIn needs centroid assignments"
        return np.isin(centroid_of, np.fromiter(self.centroids, dtype=np.int32))

    def implies(self, other):
        if isinstance(other, CentroidIn):
            return self.centroids <= other.centroids
        return False


# ---------------------------------------------------------------------------
# Conjunctive filters
# ---------------------------------------------------------------------------


def make_filter(*preds: Predicate) -> Tuple[Predicate, ...]:
    """Canonical (sorted, deduped) conjunction usable as a dict key."""
    return tuple(sorted(set(preds), key=repr))


def evaluate_filter(
    filter: Tuple[Predicate, ...],
    db: VectorDatabase,
    centroid_of: np.ndarray | None = None,
) -> np.ndarray:
    """Bitmap of tuples satisfying the conjunction (all-True for empty)."""
    out = np.ones(db.n, dtype=bool)
    for p in filter:
        out &= p.evaluate(db, centroid_of)
    return out


# ---------------------------------------------------------------------------
# Persistence (store/snapshot.py): predicates as JSON-safe state dicts
# ---------------------------------------------------------------------------

def predicate_to_state(p: Predicate) -> dict:
    """JSON-serializable description of one predicate (snapshot manifests)."""
    if isinstance(p, Cmp):
        return {"kind": "cmp", "attr": p.attr, "op": p.op, "value": float(p.value)}
    if isinstance(p, Between):
        return {"kind": "between", "attr": p.attr, "lo": float(p.lo), "hi": float(p.hi)}
    if isinstance(p, In):
        return {"kind": "in", "attr": p.attr, "values": sorted(int(v) for v in p.values)}
    if isinstance(p, Contains):
        return {"kind": "contains", "attr": p.attr, "value": int(p.value)}
    if isinstance(p, NotNull):
        return {"kind": "notnull", "attr": p.attr}
    if isinstance(p, CentroidIn):
        return {"kind": "centroid_in", "centroids": sorted(int(c) for c in p.centroids)}
    raise TypeError(f"unserializable predicate type {type(p).__name__}")


def predicate_from_state(state: dict) -> Predicate:
    kind = state["kind"]
    if kind == "cmp":
        return Cmp(state["attr"], state["op"], float(state["value"]))
    if kind == "between":
        return Between(state["attr"], float(state["lo"]), float(state["hi"]))
    if kind == "in":
        return In(state["attr"], frozenset(int(v) for v in state["values"]))
    if kind == "contains":
        return Contains(state["attr"], int(state["value"]))
    if kind == "notnull":
        return NotNull(state["attr"])
    if kind == "centroid_in":
        return CentroidIn(frozenset(int(c) for c in state["centroids"]))
    raise ValueError(f"unknown predicate kind {kind!r}")


def filter_to_state(filt: Tuple[Predicate, ...]) -> list:
    """A conjunctive filter as a JSON-safe list (order preserved)."""
    return [predicate_to_state(p) for p in filt]


def filter_from_state(state: list) -> Tuple[Predicate, ...]:
    return tuple(predicate_from_state(s) for s in state)


def filter_implies_empty(
    filter: Tuple[Predicate, ...],
    known_all_false: Tuple[Predicate, ...] | set,
) -> bool:
    """Routing test: the partition is provably empty for this filter iff some

    conjunct implies a predicate known to be all-false in the partition.
    (If p ⇒ q and no tuple satisfies q, no tuple satisfies p, hence none can
    satisfy the whole conjunction.)
    """
    for p in filter:
        for q in known_all_false:
            if p.implies(q):
                return True
    return False
