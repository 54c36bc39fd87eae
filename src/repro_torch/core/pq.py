"""Product quantization (Jégou et al. 2011): the compressed-index companion
to IVF used by the paper's FAISS baseline family (IVF-PQ) and by the
engine's compressed scan (``PlanConfig.scan_mode="pq"``).

Vectors split into M subvectors, each quantized against a 256-entry codebook
→ codes are [n, M] uint8 (d·4 / M bytes: 32× compression at d=64, M=8).
Asymmetric distance computation (ADC): per query, a [M, 256] lookup table
of partial scores; a database vector's score is the sum of its M table
lookups, so no float vector is read at scan time.

Codebook training and encoding run k-means on ``device`` (default "cuda");
``adc_tables`` and ``decode_pq`` stay numpy, so a query's LUT is the
reference's bit for bit. The ADC scan itself is the CUDA kernel of
``kernels/pq_scan.py`` on a card, its plain version on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels import ref as _ref
from ..kernels.pq_scan import pq_scan
from . import kmeans as km


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


def train_pq(
    vectors: np.ndarray,
    m: int = 8,
    *,
    nbits: int = 8,
    iters: int = 8,
    metric: str = "l2",
    seed: int = 0,
    sample_cap: int = 65_536,
    device: km.Device = "cuda",
) -> PQCodebook:
    """One k-means of 2**nbits centroids per subspace, on a sample of at most
    ``sample_cap`` rows drawn as the reference draws it."""
    n, d = vectors.shape
    if d % m:
        raise ValueError(f"d={d} not divisible by M={m}")
    k = 1 << nbits
    dsub = d // m
    rng = np.random.default_rng(seed)
    if n > sample_cap:
        vectors = vectors[rng.choice(n, sample_cap, replace=False)]
    cents = np.empty((m, k, dsub), np.float32)
    for j in range(m):
        sub = np.ascontiguousarray(vectors[:, j * dsub : (j + 1) * dsub])
        cents[j] = km.train_kmeans(sub, k, iters=iters, metric="l2", seed=seed + j, device=device)
    return PQCodebook(centroids=cents, metric=metric)


def encode_pq_tensor(
    cb: PQCodebook, vectors, device: km.Device = "cuda", chunk: int = 65_536
) -> torch.Tensor:
    """uint8 codes [n, M] left on ``device``: nearest sub-centroid (l2, first
    on ties) per subspace, assigned there ``chunk`` rows at a time.
    ``vectors``: f32 [n, d], a host array or a tensor."""
    n, d = vectors.shape
    if d != cb.d:
        raise ValueError(
            f"PQ codebook shape mismatch: codebook encodes d={cb.d} "
            f"(m={cb.m} subspaces × dsub={cb.dsub}), vectors have d={d}"
        )
    dsub = cb.dsub
    cents = [km.as_tensor(c, device) for c in cb.centroids]
    codes = torch.empty((n, cb.m), dtype=torch.uint8, device=device)
    for s in range(0, n, chunk):
        x = km.as_tensor(vectors[s : s + chunk], device)
        for j in range(cb.m):
            sub = x[:, j * dsub : (j + 1) * dsub].contiguous()
            codes[s : s + chunk, j] = km.assign_tensor(sub, cents[j], "l2").to(torch.uint8)
    return codes


def encode_pq(cb: PQCodebook, vectors: np.ndarray, device: km.Device = "cuda") -> np.ndarray:
    """``encode_pq_tensor``'s codes as a host array."""
    return encode_pq_tensor(cb, vectors, device).cpu().numpy()


def decode_pq(cb: PQCodebook, codes: np.ndarray) -> np.ndarray:
    """Reconstruction (for re-ranking / tests)."""
    n = codes.shape[0]
    out = np.empty((n, cb.m * cb.dsub), np.float32)
    for j in range(cb.m):
        out[:, j * cb.dsub : (j + 1) * cb.dsub] = cb.centroids[j][codes[:, j]]
    return out


def adc_tables(cb: PQCodebook, queries: np.ndarray) -> np.ndarray:
    """Per-query partial-score LUTs: f32 [nq, M, 256], higher = better.

    l2: -‖q_sub − c‖² summed over subspaces == -‖q − decode(code)‖².
    ip: q_sub · c summed == q · decode(code).
    """
    nq = queries.shape[0]
    dsub = cb.dsub
    luts = np.empty((nq, cb.m, cb.centroids.shape[1]), np.float32)
    for j in range(cb.m):
        qs = queries[:, j * dsub : (j + 1) * dsub]  # [nq, dsub]
        c = cb.centroids[j]  # [256, dsub]
        ip = qs @ c.T
        if cb.metric == "l2":
            luts[:, j] = 2 * ip - (qs * qs).sum(1, keepdims=True) - (c * c).sum(1)[None, :]
        else:
            luts[:, j] = ip
    return luts


def adc_scan_ref(
    luts: torch.Tensor,  # f32 [nq, M, 256]
    codes: torch.Tensor,  # uint8/int [nv, M]
    valid: torch.Tensor,  # bool [nv]
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Oracle ADC scan: scores [nq, nv] = Σ_m lut[q, m, code[v, m]] → top-k
    (``kernels.ref.adc_topk_ref``)."""
    return _ref.adc_topk_ref(luts, codes, valid, k)


@dataclasses.dataclass
class PQIndex:
    """Flat PQ index with ADC scan + optional exact re-ranking. The codes
    live on the index's device; the scan is one ``pq_scan`` launch per
    query on a card."""

    cb: PQCodebook
    codes: torch.Tensor  # uint8 [n, M] on the index's device
    vectors: Optional[np.ndarray] = None  # kept for re-ranking if provided

    @property
    def device(self) -> torch.device:
        return self.codes.device

    @staticmethod
    def build(
        vectors: np.ndarray,
        m: int = 8,
        *,
        metric: str = "l2",
        keep_vectors: bool = True,
        seed: int = 0,
        device: km.Device = "cuda",
    ) -> "PQIndex":
        cb = train_pq(vectors, m, metric=metric, seed=seed, device=device)
        codes = encode_pq_tensor(cb, vectors, device=device)
        return PQIndex(cb=cb, codes=codes, vectors=vectors if keep_vectors else None)

    def search(
        self,
        queries: np.ndarray,
        k: int,
        *,
        bitmap: Optional[np.ndarray] = None,
        rerank: int = 0,  # fetch rerank·k ADC candidates, re-score exactly
    ) -> Tuple[np.ndarray, np.ndarray]:
        n = self.codes.shape[0]
        dev = self.device
        valid = np.ones(n, bool) if bitmap is None else np.ascontiguousarray(bitmap, dtype=bool)
        valid = torch.from_numpy(valid).to(dev)
        luts = torch.from_numpy(adc_tables(self.cb, queries)).to(dev)
        kk = min(k * max(1, rerank), n)
        found = [pq_scan(luts[r], self.codes, valid, k=kk) for r in range(queries.shape[0])]
        s = torch.stack([f[0] for f in found]).cpu().numpy()
        i = torch.stack([f[1] for f in found]).cpu().numpy()
        if rerank <= 1 or self.vectors is None:
            return s[:, :k], i[:, :k].astype(np.int64)
        out_s = np.full((queries.shape[0], k), -np.inf, np.float32)
        out_i = np.full((queries.shape[0], k), -1, np.int64)
        for r in range(queries.shape[0]):
            cand = i[r][i[r] >= 0]
            if len(cand) == 0:
                continue
            vc = self.vectors[cand]
            ip = vc @ queries[r]
            if self.cb.metric == "l2":
                sc = 2 * ip - (vc * vc).sum(1) - queries[r] @ queries[r]
            else:
                sc = ip
            top = np.argsort(-sc, kind="stable")[:k]
            out_s[r, : len(top)] = sc[top]
            out_i[r, : len(top)] = cand[top]
        return out_s, out_i

    @property
    def compression_ratio(self) -> float:
        d = self.cb.m * self.cb.dsub
        return (d * 4) / self.cb.m
