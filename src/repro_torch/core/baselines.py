"""Hybrid-query baselines (Section 2.2). Ported so far: Strategy A,
exhaustive search — bitmap + full scan, the ground truth every recall figure
is measured against. PreFilter, PostFilter and Range wait for ROADMAP.md §1
item 4.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..kernels import ops as kops
from . import kmeans as km
from .predicates import evaluate_filter
from .types import SearchResult, VectorDatabase, Workload

# score-matrix elements per chunk: 2^28 f32 = 1 GiB on the device
_CHUNK_ELEMENTS = 1 << 28


def exhaustive_search(
    db: VectorDatabase,
    workload: Workload,
    *,
    chunk: Optional[int] = None,
    device: Optional[km.Device] = None,
) -> SearchResult:
    """Exact hybrid search: bitmap per template + full masked scan with the
    plain masked top-k (no kernel: this is the oracle), on ``device``
    (default "cuda"). Queries go in chunks of ``chunk`` rows, by default as
    many as keep one chunk's score matrix within 1 GiB."""
    device = torch.device("cuda" if device is None else device)
    m, k = workload.m, workload.k
    if chunk is None:
        chunk = max(1, min(4096, _CHUNK_ELEMENTS // max(db.n, 1)))
    out_s = np.full((m, k), -np.inf, np.float32)
    out_i = np.full((m, k), -1, np.int64)
    scanned = 0
    v = km.as_tensor(db.vectors, device)
    for ti, filt in enumerate(workload.templates):
        qidx = workload.queries_for_template(ti)
        if len(qidx) == 0:
            continue
        bitmap = evaluate_filter(filt, db)
        scanned += db.n * len(qidx)
        valid = torch.from_numpy(bitmap).to(device)
        for s in range(0, len(qidx), chunk):
            qs = qidx[s : s + chunk]
            sc, ix = kops.masked_topk(
                km.as_tensor(workload.vectors[qs], device), v, valid, k, metric=db.metric
            )
            out_s[qs] = sc.cpu().numpy()
            out_i[qs] = ix.cpu().numpy().astype(np.int64)
    return SearchResult(ids=out_i, scores=out_s, tuples_scanned=scanned)
