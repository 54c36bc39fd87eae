"""Evaluation metrics + nprobe tuning (Section 6.1's protocol).

recall@k against exhaustive ground truth; per-template nprobe tuned (doubling
search) until the target recall is reached — the paper tunes nprobe per query
template for Recall ≥ 0.8 at k = 10.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from .types import SearchResult, Workload


def _hits_totals(result: SearchResult, truth: SearchResult) -> tuple:
    """Per-query (retrieved-truth count, truth count), set-free.

    One broadcasted [m, k_truth, k_result] id comparison replaces the Python
    per-query set loop — this sits inside ``tune_nprobe``'s doubling search,
    so it runs O(T · log nprobe) times per tuning pass. Ids within a row are
    distinct (top-k over distinct tuples; -1 padding is masked out), so the
    any-match reduction counts each hit exactly once.
    """
    t = np.asarray(truth.ids)
    r = np.asarray(result.ids)
    t_ok = t >= 0  # [m, kt]
    match = (t[:, :, None] == r[:, None, :]) & t_ok[:, :, None] & (r >= 0)[:, None, :]
    hits = match.any(axis=2).sum(axis=1)  # [m]
    return hits.astype(np.int64), t_ok.sum(axis=1).astype(np.int64)


def recall_at_k(result: SearchResult, truth: SearchResult) -> float:
    """Fraction of ground-truth ids retrieved (micro-averaged over queries)."""
    hits, totals = _hits_totals(result, truth)
    return float(hits.sum()) / max(int(totals.sum()), 1)


def per_template_recall(result: SearchResult, truth: SearchResult, workload: Workload) -> Dict[int, float]:
    hits, totals = _hits_totals(result, truth)
    out = {}
    for ti in range(len(workload.templates)):
        qidx = workload.queries_for_template(ti)
        if len(qidx) == 0:
            continue
        out[ti] = float(hits[qidx].sum()) / max(int(totals[qidx].sum()), 1)
    return out


def tune_nprobe(
    search_fn: Callable[[Workload, Dict[int, int]], SearchResult],
    workload: Workload,
    truth: SearchResult,
    *,
    target_recall: float = 0.8,
    max_nprobe: int = 256,
    sample_per_template: int = 64,
    seed: int = 0,
) -> Dict[int, int]:
    """Per-template nprobe via doubling search on a query sample."""
    rng = np.random.default_rng(seed)
    nprobe: Dict[int, int] = {}
    for ti in range(len(workload.templates)):
        qidx = workload.queries_for_template(ti)
        if len(qidx) == 0:
            nprobe[ti] = 1
            continue
        if len(qidx) > sample_per_template:
            qidx = rng.choice(qidx, size=sample_per_template, replace=False)
        sub = workload.subset(qidx)
        sub_truth = SearchResult(ids=truth.ids[qidx], scores=truth.scores[qidx])
        # double 1, 2, 4, … but clamp the ladder's top rung AT max_nprobe so
        # the value returned is always one that was actually evaluated — a
        # non-power-of-two cap (say 100) is probed itself, never returned
        # sight-unseen after probing only 64
        np_t = 1
        while True:
            res = search_fn(sub, {0: np_t})
            if recall_at_k(res, sub_truth) >= target_recall or np_t >= max_nprobe:
                break
            np_t = min(np_t * 2, max_nprobe)
        nprobe[ti] = np_t
    return nprobe
