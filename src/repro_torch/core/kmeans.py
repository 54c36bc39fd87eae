"""Batched k-means (Lloyd's) on the device — IVF training and the
centroid-assignment attribute of Section 4.1.1.

FAISS-like defaults: k = sqrt(n), a bounded number of Lloyd's iterations
over a training sample, empty clusters re-seeded from random points. The
random draws come from numpy's ``default_rng(seed)`` in the reference's
order (sample, init rows, re-seeds), so a seed picks the same rows as
``repro.core.kmeans``. Assignment and the update run as PyTorch ops on
``device``; inputs and results are numpy.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from ..kernels import ops as kops

Device = Union[str, torch.device]


def as_tensor(x, device: Device) -> torch.Tensor:
    """float32 tensor on ``device`` from a numpy array or a tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    arr = np.ascontiguousarray(x, dtype=np.float32)
    if not arr.flags.writeable:  # e.g. a loaded state's array: never alias it
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


def assign_tensor(vectors: torch.Tensor, centroids: torch.Tensor, metric: str) -> torch.Tensor:
    """Nearest-centroid id per row (first maximum on ties): int64 [n]."""
    return torch.argmax(kops.pairwise_scores(vectors, centroids, metric=metric), dim=1)


def _update(vectors: torch.Tensor, assign: torch.Tensor, k: int):
    """Mean of each cluster via a one-hot product (deterministic, unlike an
    atomic scatter-add); returns (centroids [k, d], counts [k])."""
    one_hot = torch.nn.functional.one_hot(assign, k).to(vectors.dtype)  # [n, k]
    counts = one_hot.sum(dim=0)
    sums = one_hot.T @ vectors
    return sums / torch.clamp(counts, min=1.0)[:, None], counts


def _pow2_pad(x: np.ndarray, lo: int = 256) -> np.ndarray:
    """Pad rows to the next power of two (repeating rows), as the reference
    does: the padded row count is what the init draw samples from, so it
    must match for a seed to pick the same rows."""
    n = x.shape[0]
    target = max(lo, 1 << (n - 1).bit_length())
    if target == n:
        return x
    reps = np.resize(np.arange(n), target - n)
    return np.concatenate([x, x[reps]], axis=0)


def train_kmeans(
    vectors: np.ndarray,
    k: int,
    *,
    iters: int = 10,
    metric: str = "l2",
    seed: int = 0,
    sample_cap: int = 262_144,
    device: Device = "cuda",
) -> np.ndarray:
    """Train k centroids; returns float32 [k, d]."""
    n, d = vectors.shape
    k = int(min(k, n))
    rng = np.random.default_rng(seed)
    if n > sample_cap:
        idx = rng.choice(n, size=sample_cap, replace=False)
        x = vectors[idx]
    else:
        x = vectors
    x = as_tensor(_pow2_pad(np.asarray(x, dtype=np.float32)), device)
    init_idx = rng.choice(x.shape[0], size=k, replace=False)
    centroids = x[torch.from_numpy(init_idx).to(device)]
    for _ in range(iters):
        assign = assign_tensor(x, centroids, metric)
        centroids, counts = _update(x, assign, k)
        empty = (counts == 0).cpu().numpy()
        if empty.any():  # re-seed empty clusters from random points (rare)
            pick = rng.choice(x.shape[0], size=int(empty.sum()), replace=False)
            centroids[torch.from_numpy(empty).to(device)] = x[torch.from_numpy(pick).to(device)]
    return centroids.cpu().numpy().astype(np.float32, copy=False)


def assign_kmeans(
    vectors: np.ndarray,
    centroids: np.ndarray,
    *,
    metric: str = "l2",
    chunk: int = 65_536,
    device: Device = "cuda",
) -> np.ndarray:
    """Nearest-centroid id per vector: int32 [n] (chunked to bound device
    memory)."""
    n = vectors.shape[0]
    out = np.empty(n, dtype=np.int32)
    cents = as_tensor(centroids, device)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        out[s:e] = assign_tensor(as_tensor(vectors[s:e], device), cents, metric).cpu().numpy()
    return out


def topm_centroids(
    query_vectors, centroids, m: int, *, metric: str = "l2", device: Device = "cuda"
) -> np.ndarray:
    """m nearest centroids per query — int32 [nq, m] (Section 4.1.1 / Alg.3
    line 6); ties go to the smaller centroid id (stable descending sort)."""
    scores = kops.pairwise_scores(as_tensor(query_vectors, device), as_tensor(centroids, device), metric=metric)
    m = int(min(m, scores.shape[1]))
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :m]
    return order.cpu().numpy().astype(np.int32)
