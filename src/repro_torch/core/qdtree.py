"""Workload-aware balanced qd-tree (Section 4.1, Algorithms 1 and 2).

The tree partitions the vector database using *cut predicates* mined from a
historical hybrid-query workload: the attribute predicates of the templates
plus — when m > 0 — per-centroid ``CentroidIn`` predicates derived from the
k-means transformation of Section 4.1.1.

Balanced splits (Algorithm 1): a node accumulates a *set* S of cut predicates
until the union of their matches covers at least half the node's tuples;
left child = tuples satisfying ⋁S, right child = tuples satisfying none.

Semantic descriptions: each leaf carries
  * ``all_false``   — cut predicates no tuple in the leaf satisfies
                      (from right-branch ancestors; one entry per s ∈ S), and
  * ``all_true_or`` — predicate sets S where every tuple satisfies ⋁S
                      (from left-branch ancestors).
Routing (Section 4.1.3) prunes a leaf for a conjunctive filter f iff
  * some conjunct p ∈ f implies an all_false predicate, or
  * some conjunct p ∈ f is pairwise-disjoint with every s of an all_true_or
    set (then p ∧ ⋁S is unsatisfiable).
Both tests are conservative ⇒ routing is *sound* (never loses a result); the
property tests in tests/test_qdtree.py verify this on random workloads.

Cost model: ``cost_mode="tuples"`` implements Eq. (1) directly
(Σ |P_i| · #templates routed, weighted by query counts); ``"queries"`` is the
unweighted count as literally printed in Algorithm 2. Default is "tuples"
since Eq. (1) is the paper's stated objective.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .predicates import (
    CentroidIn,
    Predicate,
    predicate_from_state,
    predicate_to_state,
)
from .types import VectorDatabase, Workload


@dataclasses.dataclass
class Leaf:
    leaf_id: int
    rows: np.ndarray  # int64 indices into the original DB
    all_false: List[int]  # cut-pred indices no tuple satisfies
    all_true_or: List[Tuple[int, ...]]  # sets S with "every tuple satisfies ⋁S"
    depth: int


@dataclasses.dataclass
class QDTree:
    preds: List[Predicate]  # the extracted cut predicates
    leaves: List[Leaf]
    imp: np.ndarray  # bool [C, C]: imp[i, j] = preds[i] ⇒ preds[j]
    disj: np.ndarray  # bool [C, C]: preds[i] ∧ preds[j] unsatisfiable
    n_centroids: int = 0  # coarse centroids (m > 0 mode); 0 = attributes only

    @property
    def n_leaves(self) -> int:
        return len(self.leaves)

    # -- persistence -------------------------------------------------------

    def to_state(self) -> dict:
        """Snapshot state (store/snapshot.py): the full tree structure —
        cut predicates, implication/disjointness tables, and every leaf's
        row set + semantic description — so routing after a load is
        bit-identical to the tree that was saved (no re-mining)."""
        return {
            "n_centroids": int(self.n_centroids),
            "preds": [predicate_to_state(p) for p in self.preds],
            "imp": self.imp,
            "disj": self.disj,
            "leaves": [
                {
                    "leaf_id": int(leaf.leaf_id),
                    "rows": leaf.rows,
                    "all_false": [int(c) for c in leaf.all_false],
                    "all_true_or": [[int(s) for s in S] for S in leaf.all_true_or],
                    "depth": int(leaf.depth),
                }
                for leaf in self.leaves
            ],
        }

    @staticmethod
    def from_state(state: dict) -> "QDTree":
        return QDTree(
            preds=[predicate_from_state(s) for s in state["preds"]],
            leaves=[
                Leaf(
                    leaf_id=int(ls["leaf_id"]),
                    rows=np.asarray(ls["rows"]),
                    all_false=[int(c) for c in ls["all_false"]],
                    all_true_or=[tuple(int(s) for s in S) for S in ls["all_true_or"]],
                    depth=int(ls["depth"]),
                )
                for ls in state["leaves"]
            ],
            imp=np.asarray(state["imp"]),
            disj=np.asarray(state["disj"]),
            n_centroids=int(state["n_centroids"]),
        )

    # -- routing -----------------------------------------------------------

    def _match_pred(self, p: Predicate) -> Tuple[np.ndarray, np.ndarray]:
        """(implies_vec, disjoint_vec) of p against the cut-pred set."""
        C = len(self.preds)
        imp = np.zeros(C, dtype=bool)
        dis = np.zeros(C, dtype=bool)
        try:
            i = self.preds.index(p)
            return self.imp[i], self.disj[i]
        except ValueError:
            pass
        for j, c in enumerate(self.preds):
            if p.implies(c):
                imp[j] = True
            if predicates_disjoint(p, c):
                dis[j] = True
        return imp, dis

    def route_filter(self, filt: Tuple[Predicate, ...]) -> np.ndarray:
        """bool [n_leaves]: which leaves may contain matches for the filter."""
        out = np.ones(self.n_leaves, dtype=bool)
        if not filt:
            return out
        per_conj = [self._match_pred(p) for p in filt]
        for li, leaf in enumerate(self.leaves):
            pruned = False
            for imp, dis in per_conj:
                if any(imp[c] for c in leaf.all_false):
                    pruned = True
                    break
                if any(all(dis[s] for s in S) for S in leaf.all_true_or):
                    pruned = True
                    break
            out[li] = not pruned
        return out

    def centroid_allowed(self) -> Optional[np.ndarray]:
        """bool [n_leaves, n_centroids]: leaf may contain tuples of centroid c.

        None when the tree was built attribute-only (m = 0).
        """
        if self.n_centroids == 0:
            return None
        allowed = np.ones((self.n_leaves, self.n_centroids), dtype=bool)
        cent_sets = [
            (i, p.centroids) for i, p in enumerate(self.preds) if isinstance(p, CentroidIn)
        ]
        pred_to_set = dict(cent_sets)
        for li, leaf in enumerate(self.leaves):
            for c in leaf.all_false:
                if c in pred_to_set:
                    allowed[li, list(pred_to_set[c])] = False
            for S in leaf.all_true_or:
                if all(s in pred_to_set for s in S):
                    union: Set[int] = set()
                    for s in S:
                        union |= pred_to_set[s]
                    mask = np.zeros(self.n_centroids, dtype=bool)
                    mask[list(union)] = True
                    allowed[li] &= mask
        return allowed

    def route_tuples(
        self, db: VectorDatabase, centroid_of: Optional[np.ndarray] = None
    ) -> np.ndarray:
        """int64 [db.n]: the unique leaf each tuple belongs to.

        Each leaf's semantic description is exactly its root-to-leaf path:
        every left turn contributes an all_true_or set S (the tuple satisfies
        ⋁S) and every right turn contributes |S| all_false predicates (the
        tuple satisfies none of them). Since each split partitions its node
        on ⋁S, the descriptions partition tuple space — this is how the
        serving layer's ``refresh()`` folds freshly inserted tuples into the
        existing partitioning without re-running Algorithm 1.
        """
        n = db.n
        if not self.preds or len(self.leaves) == 1:
            return np.zeros(n, dtype=np.int64)
        pm = np.stack([p.evaluate(db, centroid_of) for p in self.preds])  # [C, n]
        out = np.full(n, -1, dtype=np.int64)
        for li, leaf in enumerate(self.leaves):
            mask = out < 0
            for c in leaf.all_false:
                mask &= ~pm[c]
            for S in leaf.all_true_or:
                acc = np.zeros(n, dtype=bool)
                for s in S:
                    acc |= pm[s]
                mask &= acc
            out[mask] = li
        assert (out >= 0).all(), "leaf descriptions must cover tuple space"
        return out


def predicates_disjoint(p: Predicate, q: Predicate) -> bool:
    """Conservative: True only if p ∧ q is provably unsatisfiable."""
    from .predicates import Between, Cmp, Contains, In, NotNull

    if isinstance(p, CentroidIn) and isinstance(q, CentroidIn):
        return not (p.centroids & q.centroids)
    attr_p = getattr(p, "attr", None)
    attr_q = getattr(q, "attr", None)
    if attr_p is None or attr_p != attr_q:
        return False
    if isinstance(p, Between) and isinstance(q, Between):
        return p.hi <= q.lo or q.hi <= p.lo
    if isinstance(p, In) and isinstance(q, In):
        return not (p.values & q.values)
    if isinstance(p, Cmp) and isinstance(q, Cmp) and p.op == "==" and q.op == "==":
        return p.value != q.value
    if isinstance(p, Between) and isinstance(q, Cmp):
        if q.op == "==":
            return not (p.lo <= q.value < p.hi)
        if q.op in ("<", "<="):
            return p.lo > q.value or (q.op == "<" and p.lo >= q.value)
        if q.op in (">", ">="):
            # [lo, hi) lies entirely at or below q.value in both cases: every
            # range member is < hi <= q.value, so none is > (or >=) q.value
            return p.hi <= q.value
    if isinstance(q, Between) and isinstance(p, Cmp):
        return predicates_disjoint(q, p)
    return False


# ---------------------------------------------------------------------------
# Construction (Algorithms 1 + 2)
# ---------------------------------------------------------------------------


def extract_cut_predicates(
    templates: Sequence[Tuple[Predicate, ...]],
    query_centroids: Optional[np.ndarray] = None,
) -> List[Predicate]:
    """All unary predicates in the workload + per-centroid predicates."""
    preds: List[Predicate] = []
    seen = set()
    for t in templates:
        for p in t:
            if p not in seen:
                seen.add(p)
                preds.append(p)
    if query_centroids is not None:
        for c in np.unique(query_centroids):
            p = CentroidIn(frozenset([int(c)]))
            if p not in seen:
                seen.add(p)
                preds.append(p)
    return preds


def build_qdtree(
    db: VectorDatabase,
    workload: Workload,
    *,
    centroid_of: Optional[np.ndarray] = None,  # t.c per tuple (m > 0 mode)
    query_centroids: Optional[np.ndarray] = None,  # q.c [m, m_cent]
    n_centroids: int = 0,
    min_size: int = 4096,
    max_leaves: int = 4096,
    max_preds_per_split: int = 8,
    cost_mode: str = "tuples",
    template_weights: Optional[np.ndarray] = None,
) -> QDTree:
    preds = extract_cut_predicates(workload.templates, query_centroids)
    C = len(preds)
    n = db.n
    if C == 0:
        # No usable cut predicates: single leaf.
        return QDTree(preds=[], leaves=[Leaf(0, np.arange(n), [], [], 0)], imp=np.zeros((0, 0), bool), disj=np.zeros((0, 0), bool), n_centroids=n_centroids)

    # Evaluate every cut predicate once over V: bool [C, n].
    pred_matrix = np.stack([p.evaluate(db, centroid_of) for p in preds])

    # Pairwise implication / disjointness between cut predicates.
    imp = np.zeros((C, C), dtype=bool)
    disj = np.zeros((C, C), dtype=bool)
    for i in range(C):
        for j in range(C):
            if i != j and preds[i].implies(preds[j]):
                imp[i, j] = True
            if i < j and predicates_disjoint(preds[i], preds[j]):
                disj[i, j] = disj[j, i] = True
        imp[i, i] = True

    # Template → conjunct cut-pred indices; weights = query counts.
    pred_index = {p: i for i, p in enumerate(preds)}
    T = len(workload.templates)
    conj_tid: List[int] = []
    conj_pid: List[int] = []
    for ti, t in enumerate(workload.templates):
        for p in t:
            conj_tid.append(ti)
            conj_pid.append(pred_index[p])
    conj_tid_a = np.array(conj_tid, dtype=np.int64)
    conj_pid_a = np.array(conj_pid, dtype=np.int64)
    if template_weights is None:
        template_weights = np.bincount(workload.template_of, minlength=T).astype(np.float64)
    # M_imp[t, c]: template t has a conjunct implying cut pred c
    M_imp = np.zeros((T, C), dtype=bool)
    if len(conj_tid_a):
        np.logical_or.at(M_imp, conj_tid_a, imp[conj_pid_a])

    leaves: List[Leaf] = []

    def routed_weight(tmask: np.ndarray) -> float:
        return float(template_weights[tmask].sum())

    def recurse(
        rows: np.ndarray,
        tmpl_alive: np.ndarray,  # bool [T] — templates routed to this node
        all_false: List[int],
        all_true_or: List[Tuple[int, ...]],
        depth: int,
    ) -> None:
        nP = len(rows)
        if nP <= min_size or len(leaves) + 1 >= max_leaves or not tmpl_alive.any():
            leaves.append(Leaf(len(leaves), rows, list(all_false), list(all_true_or), depth))
            return

        sub = pred_matrix[:, rows]  # [C, nP]
        counts = sub.sum(axis=1)
        # usable candidates: split the node non-trivially, not already decided
        decided = np.zeros(C, dtype=bool)
        decided[list(all_false)] = True
        usable = (counts > 0) & (counts < nP) & ~decided

        S: List[int] = []
        left_mask = np.zeros(nP, dtype=bool)
        # conjunct "alive for disjointness" state: ∀s∈S disj[conj, s]
        conj_alive = np.ones(len(conj_pid_a), dtype=bool)
        pre_right = np.zeros(T, dtype=bool)  # templates pruned from right by S so far
        pre_left = np.zeros(T, dtype=bool)

        while left_mask.sum() <= nP // 2 and len(S) < max_preds_per_split:
            cand = np.nonzero(usable)[0]
            if len(cand) == 0:
                break
            # --- Algorithm 2 (vectorized over candidates) ---
            # right-prune: template has a conjunct implying any s ∈ S∪{p}
            pr_right = pre_right[:, None] | M_imp[:, cand]  # [T, |cand|]
            # left-prune: some conjunct disjoint with every s ∈ S∪{p}
            pr_left = np.zeros((T, len(cand)), dtype=bool)
            if len(conj_pid_a):
                dmat = disj[conj_pid_a][:, cand]  # [J, |cand|]
                alive_d = conj_alive[:, None] & dmat
                np.logical_or.at(pr_left, conj_tid_a, alive_d)
            w = template_weights * tmpl_alive
            wq_left = ((~pr_left) * w[:, None]).sum(axis=0)
            wq_right = ((~pr_right) * w[:, None]).sum(axis=0)
            new_left = left_mask[None, :] | sub[cand]  # [|cand|, nP]
            nL = new_left.sum(axis=1).astype(np.float64)
            nR = nP - nL
            if cost_mode == "tuples":
                cost = nL * wq_left + nR * wq_right  # Eq. (1)
            else:
                cost = wq_left + wq_right  # Algorithm 2 as printed
            # tie-break toward balance
            cost = cost + 1e-9 * np.abs(nL - nP / 2.0)
            best = int(cand[np.argmin(cost)])
            gain_rows = int((sub[best] & ~left_mask).sum())
            if gain_rows == 0 and len(S) > 0:
                usable[best] = False
                continue
            S.append(best)
            left_mask |= sub[best]
            usable[best] = False
            pre_right |= M_imp[:, best]
            # pre_left[t] = ∃ conjunct of t disjoint with every s ∈ S
            pre_left = np.zeros(T, dtype=bool)
            if len(conj_pid_a):
                conj_alive &= disj[conj_pid_a, best]
                np.logical_or.at(pre_left, conj_tid_a, conj_alive)

        nL = int(left_mask.sum())
        if not S or nL == 0 or nL == nP:
            leaves.append(Leaf(len(leaves), rows, list(all_false), list(all_true_or), depth))
            return

        t_left = tmpl_alive & ~pre_left
        t_right = tmpl_alive & ~pre_right
        recurse(rows[left_mask], t_left, all_false, all_true_or + [tuple(S)], depth + 1)
        recurse(rows[~left_mask], t_right, all_false + list(S), all_true_or, depth + 1)

    recurse(np.arange(n, dtype=np.int64), np.ones(T, dtype=bool), [], [], 0)
    return QDTree(preds=preds, leaves=leaves, imp=imp, disj=disj, n_centroids=n_centroids)
