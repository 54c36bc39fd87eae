"""Product quantization (Jégou et al. 2011): the parts the port needs to
load an index's saved state.

Vectors split into M subvectors, each quantized against a 256-entry codebook
→ codes are [n, M] uint8. ``PQCodebook`` round-trips through
``to_state``/``from_state`` and ``encode_pq`` encodes rows (numpy), so a
reference index built with ``scan_mode="pq"`` loads and serves exact f32
searches. Training a codebook and the compressed (ADC) scan path are not
ported yet: ROADMAP.md §1 item 4.
"""
from __future__ import annotations

import dataclasses

import numpy as np

PQ_NOT_PORTED = "compressed (PQ) search is not ported yet: ROADMAP.md §1 item 4"


@dataclasses.dataclass
class PQCodebook:
    centroids: np.ndarray  # f32 [M, 256, dsub]
    metric: str

    @property
    def m(self) -> int:
        return int(self.centroids.shape[0])

    @property
    def dsub(self) -> int:
        return int(self.centroids.shape[2])

    @property
    def d(self) -> int:
        """Vector dimensionality this codebook encodes (m · dsub)."""
        return self.m * self.dsub

    def to_state(self) -> dict:
        return {"metric": self.metric, "centroids": self.centroids}

    @staticmethod
    def from_state(state: dict) -> "PQCodebook":
        return PQCodebook(
            centroids=np.asarray(state["centroids"]), metric=state["metric"]
        )


def train_pq(*args, **kwargs) -> PQCodebook:
    raise NotImplementedError(PQ_NOT_PORTED)


def encode_pq(cb: PQCodebook, vectors: np.ndarray) -> np.ndarray:
    """uint8 codes [n, M]: nearest sub-centroid (l2, first on ties) per
    subspace."""
    n, d = vectors.shape
    if d != cb.d:
        raise ValueError(
            f"PQ codebook shape mismatch: codebook encodes d={cb.d} "
            f"(m={cb.m} subspaces × dsub={cb.dsub}), vectors have d={d}"
        )
    dsub = cb.dsub
    codes = np.empty((n, cb.m), np.uint8)
    for j in range(cb.m):
        sub = np.asarray(vectors[:, j * dsub : (j + 1) * dsub], dtype=np.float32)
        c = cb.centroids[j]
        scores = 2.0 * (sub @ c.T) - (sub * sub).sum(1, keepdims=True) - (c * c).sum(1)[None, :]
        codes[:, j] = np.argmax(scores, axis=1).astype(np.uint8)
    return codes
