"""Deterministic, sharded synthetic data pipeline.

A copy of ``repro.data.pipeline`` (numpy only): the same batches for the
same ``(seed, step, shard)``, so the port's trainer sees the reference's
data. Every batch is a pure function of (seed, step, shard) — this is the
fault-tolerance/straggler primitive: any host can (re)compute any shard of
any step with no coordination, restarts replay identically, and elastic
re-sharding (different host count) is just a different shard slicing of the
same step stream. A background prefetch thread keeps one batch ahead.

The "corpus" is a mixture of Zipfian token draws and repeated n-gram motifs
so that a small LM shows a real, declining loss curve, while needing no
files on disk.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1  # hosts
    zipf_a: float = 1.2
    motif_len: int = 16
    n_motifs: int = 512


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # fixed motif bank (the learnable structure)
        self.motifs = rng.integers(2, cfg.vocab, size=(cfg.n_motifs, cfg.motif_len)).astype(
            np.int32
        )
        # Zipf over vocab via inverse-CDF on ranks
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self.zipf_cdf = np.cumsum(p / p.sum())

    def _tokens(self, rng: np.random.Generator, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.int32)
        i = 0
        while i < n:
            if rng.random() < 0.5:
                m = self.motifs[rng.integers(0, self.cfg.n_motifs)]
                ln = min(len(m), n - i)
                out[i : i + ln] = m[:ln]
                i += ln
            else:
                ln = min(int(rng.integers(4, 17)), n - i)
                u = rng.random(ln)
                out[i : i + ln] = np.searchsorted(self.zipf_cdf, u).astype(np.int32)
                i += ln
        return out

    def batch(self, step: int, shard: int = 0) -> Dict[str, np.ndarray]:
        """The shard's slice of the global batch at ``step`` (pure function)."""
        cfg = self.cfg
        assert cfg.global_batch % cfg.n_shards == 0
        per_shard = cfg.global_batch // cfg.n_shards
        rng = np.random.default_rng((cfg.seed, step, shard))
        toks = np.stack([self._tokens(rng, cfg.seq_len + 1) for _ in range(per_shard)])
        return {"tokens": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32)}


class Prefetcher:
    """One-batch-ahead background prefetch over a SyntheticLM stream."""

    def __init__(self, ds: SyntheticLM, start_step: int = 0, shard: int = 0, depth: int = 2):
        self.ds = ds
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.shard = shard
        self._stop = threading.Event()
        self._step = start_step
        self.t = threading.Thread(target=self._run, daemon=True)
        self.t.start()

    def _run(self):
        s = self._step
        while not self._stop.is_set():
            b = self.ds.batch(s, self.shard)
            try:
                self.q.put((s, b), timeout=1.0)
                s += 1
            except queue.Full:
                continue

    def next(self):
        return self.q.get()

    def stop(self):
        self._stop.set()
