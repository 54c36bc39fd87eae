"""Quickstart on PyTorch: build an HQI over a toy KG and run hybrid queries.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The port's version of ``examples/quickstart.py`` (``repro_torch``, on the
card unless ``--device cpu``).
"""
import argparse

import numpy as np

from repro_torch.core import (
    Column, Contains, HQIConfig, HQIIndex, NotNull, VectorDatabase, Workload,
    exhaustive_search, make_filter, recall_at_k,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)

    # --- a tiny "knowledge graph": 5k entities, typed, with embeddings --------
    n, d, n_types = 5_000, 32, 6
    type_of = rng.integers(0, n_types, n)
    centers = rng.normal(size=(n_types, d)).astype(np.float32) * 2
    vectors = (centers[type_of] + rng.normal(size=(n, d))).astype(np.float32)
    membership = np.zeros((n, n_types), dtype=bool)
    membership[np.arange(n), type_of] = True
    height = Column.numeric("height", rng.random(n), null_mask=(type_of != 0) | (rng.random(n) < 0.2))

    db = VectorDatabase(
        vectors=vectors,
        columns={"type": Column.setcat("type", membership), "height": height},
        metric="ip",
    )

    # --- a workload: "find entities similar to X that are Persons with height"
    person_with_height = make_filter(Contains("type", 0), NotNull("height"))
    any_song = make_filter(Contains("type", 1))
    queries = rng.integers(0, n, 200)
    workload = Workload(
        vectors=vectors[queries] + 0.05 * rng.normal(size=(200, d)).astype(np.float32),
        templates=[person_with_height, any_song],
        template_of=(queries % 2).astype(np.int32),
        k=10,
    )

    # --- build the workload-aware index and run the batch ---------------------
    hqi = HQIIndex.build(db, workload, HQIConfig(min_partition_size=512, max_leaves=16), device=args.device)
    result = hqi.search(workload, nprobe=8)
    truth = exhaustive_search(db, workload, device=args.device)

    print(f"partitions: {hqi.tree.n_leaves}, sizes: {hqi.partition_sizes().tolist()}")
    print(f"recall@10 vs exhaustive: {recall_at_k(result, truth):.3f}")
    print(f"tuples scanned: {result.tuples_scanned:,} "
          f"(exhaustive would scan {db.n * workload.m:,})")
    print("first query's top-5 ids:", result.ids[0][:5].tolist())
    assert recall_at_k(result, truth) > 0.7
    print("OK")


if __name__ == "__main__":
    main()
