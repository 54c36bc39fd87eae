"""Workload and dataset generators.

Two families, mirroring Section 6.1:

  * ``synthetic_bigann_style`` — BIGANN-style vectors with two random float
    attributes A, B and 20 range predicates of selectivity 2⁻ⁱ (10 per
    attribute); query log = Cartesian product of filters × query vectors.
    Used for the MSTuring/SIFT/YandexT2I-shaped experiments (Fig. 6, 7b, 7c).

  * ``kg_style`` — a KG-entity-shaped dataset with typed entities, set-valued
    type tags, NULL-heavy numeric/categorical properties, and *correlated*
    vectors (entities of a type cluster in embedding space — the correlation
    Section 2.3 calls out). The workload follows Table 1: ten templates
    (T1..T10) with skewed frequencies and selectivities from <0.005% to 60%,
    with IS NOT NULL / IN / Contains predicates over multiple attributes, and
    four temporal splits t0..t3 with mild drift (filter stability).
    Used for the RelatedQS/LP-shaped experiments (Tables 3–5, Fig. 4, 5, 7a).
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, Hashable, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .predicates import Between, Cmp, Contains, In, NotNull, make_filter
from .types import Column, METRIC_IP, METRIC_L2, VectorDatabase, Workload


# ---------------------------------------------------------------------------
# BIGANN-style synthetic (Section 6.1's public-dataset protocol)
# ---------------------------------------------------------------------------


def synthetic_bigann_style(
    n: int = 100_000,
    d: int = 64,
    n_query_vecs: int = 100,
    *,
    metric: str = METRIC_L2,
    levels: int = 10,
    seed: int = 0,
) -> Tuple[VectorDatabase, Workload, Dict[int, float]]:
    """Vectors + attrs A,B ~ U[0,1); 2·levels range predicates of sel. 2⁻ⁱ;

    query log = all filters × all query vectors (as in the paper). Returns
    (db, workload, selectivity per template index).
    """
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    a = rng.random(n).astype(np.float32)
    b = rng.random(n).astype(np.float32)
    db = VectorDatabase(
        vectors=vecs,
        columns={"A": Column.numeric("A", a), "B": Column.numeric("B", b)},
        metric=metric,
    )
    qvecs = rng.normal(size=(n_query_vecs, d)).astype(np.float32)
    templates = []
    sel = {}
    for attr in ("A", "B"):
        for i in range(levels):
            t = make_filter(Between(attr, 0.0, float(2.0**-i)))
            sel[len(templates)] = 2.0**-i
            templates.append(t)
    # Cartesian product: every query vector with every filter
    T = len(templates)
    vectors = np.repeat(qvecs, T, axis=0)
    template_of = np.tile(np.arange(T, dtype=np.int32), n_query_vecs)
    wl = Workload(vectors=vectors, templates=templates, template_of=template_of)
    return db, wl, sel


# ---------------------------------------------------------------------------
# KG-style industrial workload (RelatedQS / LP shaped)
# ---------------------------------------------------------------------------

# Table 1: (frequency at t0..t3, feasible-entity fraction) for T1..T10.
_TABLE1 = [
    # freq t0,  t1,   t2,   t3,   selectivity
    (0.15, 0.17, 0.17, 0.18, 0.00005),  # T1
    (0.26, 0.26, 0.26, 0.26, 0.001),  # T2
    (0.01, 0.01, 0.01, 0.01, 0.001),  # T3
    (0.24, 0.20, 0.20, 0.20, 0.005),  # T4
    (0.11, 0.12, 0.11, 0.12, 0.005),  # T5
    (0.02, 0.02, 0.02, 0.02, 0.01),  # T6
    (0.03, 0.03, 0.04, 0.03, 0.025),  # T7
    (0.15, 0.15, 0.15, 0.14, 0.30),  # T8
    (0.01, 0.01, 0.01, 0.01, 0.58),  # T9
    (0.04, 0.04, 0.04, 0.04, 0.60),  # T10
]


@dataclasses.dataclass
class KGDataset:
    db: VectorDatabase
    templates: List[tuple]
    selectivities: Dict[int, float]
    splits: List[Workload]  # t0..t3
    entity_type_of: np.ndarray


def kg_style(
    n: int = 100_000,
    d: int = 64,
    queries_per_split: int = 2_000,
    *,
    n_types: int = 12,
    seed: int = 0,
    metric: str = METRIC_IP,
) -> KGDataset:
    rng = np.random.default_rng(seed)

    # --- entities: type-clustered vectors (type ↔ vector correlation) -------
    type_of = rng.integers(0, n_types, size=n)
    type_centers = rng.normal(size=(n_types, d)).astype(np.float32) * 2.0
    vecs = (type_centers[type_of] + rng.normal(size=(n, d)).astype(np.float32)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True) + 1e-6

    # --- attributes ----------------------------------------------------------
    # "type": set-valued (primary type + optional secondary tags)
    membership = np.zeros((n, n_types), dtype=bool)
    membership[np.arange(n), type_of] = True
    extra = rng.random(n) < 0.2
    membership[np.nonzero(extra)[0], rng.integers(0, n_types, size=int(extra.sum()))] = True

    # numeric properties with type-dependent presence (NULL-heavy):
    def prop(presence_by_type: np.ndarray) -> Column:
        present = rng.random(n) < presence_by_type[type_of]
        vals = rng.random(n).astype(np.float32)
        return Column.numeric("x", vals, null_mask=~present)

    # "height": mostly only for type 0 ("Person"-like)
    pres = np.full(n_types, 0.02)
    pres[0] = 0.9
    height = prop(pres)
    height.name = "height"
    # "release_date": types 1,2 ("Song"/"Album"-like)
    pres = np.full(n_types, 0.05)
    pres[1] = pres[2] = 0.8
    release = prop(pres)
    release.name = "release_date"
    # "popularity": broadly present
    pres = np.full(n_types, 0.7)
    popularity = prop(pres)
    popularity.name = "popularity"
    # "country": categorical, broadly present
    country = Column.categorical(
        "country", rng.integers(0, 50, size=n).astype(np.int32), null_mask=rng.random(n) < 0.3
    )

    db = VectorDatabase(
        vectors=vecs,
        columns={
            "type": Column.setcat("type", membership),
            "height": height,
            "release_date": release,
            "popularity": popularity,
            "country": country,
        },
        metric=metric,
    )

    # --- templates tuned to Table-1 selectivities ----------------------------
    # Build candidate predicates, then calibrate each template to its target
    # selectivity by intersecting with a popularity range.
    def calibrated(base: tuple, target: float) -> tuple:
        from .predicates import evaluate_filter

        base_mask = evaluate_filter(base, db)
        frac = base_mask.mean()
        if frac <= target or frac == 0:
            return base
        # intersect with popularity < x to reach target
        pop = db.columns["popularity"]
        vals = pop.values[base_mask & ~pop.null_mask]
        if len(vals) == 0:
            return base
        keep = target / frac
        x = float(np.quantile(vals, min(1.0, keep)))
        return make_filter(*base, Cmp("popularity", "<", x), NotNull("popularity"))

    raw = [
        make_filter(Contains("type", 0), NotNull("height"), In("country", frozenset(range(2)))),  # T1
        make_filter(Contains("type", 0), NotNull("height")),  # T2
        make_filter(Contains("type", 1), NotNull("release_date"), In("country", frozenset(range(5)))),  # T3
        make_filter(Contains("type", 1), NotNull("release_date")),  # T4
        make_filter(Contains("type", 2), NotNull("release_date")),  # T5
        make_filter(Contains("type", 3), NotNull("popularity")),  # T6
        make_filter(In("country", frozenset(range(10))), NotNull("popularity")),  # T7
        make_filter(NotNull("popularity"), Cmp("popularity", ">=", 0.0)),  # T8
        make_filter(NotNull("country")),  # T9
        make_filter(NotNull("popularity")),  # T10
    ]
    templates = [calibrated(t, _TABLE1[i][4]) for i, t in enumerate(raw)]
    from .predicates import evaluate_filter

    sels = {i: float(evaluate_filter(t, db).mean()) for i, t in enumerate(templates)}

    # --- temporal splits (filter commonality + stability) --------------------
    splits = []
    for s in range(4):
        freqs = np.array([_TABLE1[i][s] for i in range(10)], dtype=np.float64)
        freqs /= freqs.sum()
        t_of = rng.choice(10, size=queries_per_split, p=freqs).astype(np.int32)
        # query vectors: embeddings of entities sampled near template-relevant
        # types (queries correlate with their filters, as in real KG logs)
        qv = np.empty((queries_per_split, d), dtype=np.float32)
        for i in range(queries_per_split):
            ti = t_of[i]
            if ti <= 5:
                base_type = [0, 0, 1, 1, 2, 3][ti]
            else:
                base_type = int(rng.integers(0, n_types))
            ent = rng.integers(0, n)
            # bias toward entities of the relevant type
            tries = 0
            while type_of[ent] != base_type and tries < 4:
                ent = rng.integers(0, n)
                tries += 1
            qv[i] = vecs[ent] + 0.05 * rng.normal(size=d).astype(np.float32)
        splits.append(Workload(vectors=qv, templates=list(templates), template_of=t_of))

    return KGDataset(
        db=db, templates=list(templates), selectivities=sels, splits=splits, entity_type_of=type_of
    )


# ---------------------------------------------------------------------------
# Workload reconstruction from observed traffic (the hot-swap tuner's input)
# ---------------------------------------------------------------------------


def reconstruct_workload(
    traffic: Sequence[Tuple[float, Hashable]],
    samples: Iterable[Tuple[np.ndarray, tuple, np.ndarray]] = (),
    *,
    fallback_vectors: np.ndarray,
    n_queries: int = 256,
    k: int = 10,
    seed: int = 0,
) -> Optional[Workload]:
    """A representative ``Workload`` rebuilt from drift-window observations.

    ``traffic`` is ``DriftMonitor.traffic_snapshot()``'s template window —
    ``(t, filter-tuple)`` pairs — and ``samples`` its recall reservoir
    (``(vector, filter, served_ids)``). Template *shares* come from traffic
    counts; query *vectors* per template come from the reservoir when it
    sampled that filter, else are drawn from ``fallback_vectors`` (the live
    DB rows — self-similarity is the standard stand-in when the real query
    vectors weren't retained). Returns None when the window is empty: no
    traffic means no evidence to re-partition on.

    Deterministic for a fixed (traffic, samples, seed): templates are
    ordered by their stringified filter, and every template observed in the
    window gets at least one query so rare-but-present filters keep their
    qd-tree say.
    """
    counts: Counter = Counter(key for _, key in traffic)
    if not counts:
        return None
    rng = np.random.default_rng(seed)
    templates = sorted(counts, key=str)
    total = sum(counts.values())
    pool: Dict[Hashable, List[np.ndarray]] = {}
    for vec, filt, _ in samples:
        pool.setdefault(filt, []).append(np.asarray(vec, dtype=np.float32))
    fallback = np.asarray(fallback_vectors, dtype=np.float32)
    vec_chunks: List[np.ndarray] = []
    t_of: List[int] = []
    for ti, filt in enumerate(templates):
        m = max(1, round(n_queries * counts[filt] / total))
        sampled = pool.get(filt, [])
        if sampled:
            picks = rng.integers(0, len(sampled), size=m)
            vec_chunks.append(np.stack([sampled[j] for j in picks]))
        else:
            vec_chunks.append(fallback[rng.integers(0, len(fallback), size=m)])
        t_of.extend([ti] * m)
    return Workload(
        vectors=np.concatenate(vec_chunks, axis=0),
        templates=list(templates),
        template_of=np.asarray(t_of, dtype=np.int32),
        k=int(k),
    )


def lp_style(
    n: int = 100_000,
    d: int = 64,
    n_queries: int = 2_000,
    *,
    n_types: int = 12,
    seed: int = 1,
) -> Tuple[VectorDatabase, Workload]:
    """Link-prediction-shaped workload: template = type-membership predicate

    only; no historical log (so HQI's qd-tree stage is skipped for it —
    batching-only, as in the paper)."""
    ds = kg_style(n, d, n_queries, n_types=n_types, seed=seed)
    rng = np.random.default_rng(seed + 1)
    t_of = rng.integers(0, n_types, size=n_queries).astype(np.int32)
    templates = [make_filter(Contains("type", t)) for t in range(n_types)]
    qv = ds.db.vectors[rng.integers(0, n, size=n_queries)] + 0.05 * rng.normal(
        size=(n_queries, d)
    ).astype(np.float32)
    wl = Workload(vectors=qv.astype(np.float32), templates=templates, template_of=t_of)
    return ds.db, wl
