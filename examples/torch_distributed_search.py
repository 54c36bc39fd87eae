"""Distributed batch hybrid search on a device mesh (sharded engine), on
PyTorch.

    PYTHONPATH=src python examples/torch_distributed_search.py [--device cpu] [--tiny]

The port's version of ``examples/distributed_search.py`` (on the card unless
``--device cpu``; ``--tiny``: 8,000 rows and 128 queries). The packed arena
is sharded over the "model" axis (contiguous posting-list slices per rank),
the workload is planned ONCE and its work units route to the rank storing
their posting list, every bucket executes as one sharded dispatch with
bitmap pushdown intact, and the only cross-rank traffic is the k·|model|
per-query candidate gather. Results are bit-identical to the single-device
engine. The port's engine is single-controller, so the (2, 4) mesh here is
eight ranks on the one device (no simulated host devices are needed).
"""
import argparse

import numpy as np

from repro_torch.core import Column, VectorDatabase
from repro_torch.core.ivf import IVFIndex
from repro_torch.core.planner import batch_search_ivf
from repro_torch.core.predicates import Contains, evaluate_filter, make_filter
from repro_torch.launch.mesh import make_test_mesh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    n, d, m, k = (8_000, 32, 128, 10) if args.tiny else (64_000, 32, 512, 10)
    mesh = make_test_mesh((2, 4), ("data", "model"), device=args.device)
    print(f"devices: {len(set(mesh.devices.flat))} ({mesh.devices.flat[0]}), mesh: {dict(mesh.shape)}")

    membership = rng.random((n, 4)) < 0.3
    membership[np.arange(n), rng.integers(0, 4, n)] = True
    db = VectorDatabase(
        vectors=rng.normal(size=(n, d)).astype(np.float32),
        columns={"type": Column.setcat("type", membership)},
        metric="ip",
    )
    bitmap = evaluate_filter(make_filter(Contains("type", 2)), db)
    queries = rng.normal(size=(m, d)).astype(np.float32)

    ivf = IVFIndex.build(db.vectors, metric="ip", n_centroids=64, seed=0, device=args.device)
    scores, ids = batch_search_ivf(
        ivf, queries, nprobe=16, k=k, bitmap=bitmap, mesh=mesh
    )

    # verify against the single-device engine: results must be bit-identical
    s_ref, i_ref = batch_search_ivf(ivf, queries, nprobe=16, k=k, bitmap=bitmap)
    assert np.array_equal(scores, s_ref) and np.array_equal(ids, i_ref)
    print(f"searched {m} hybrid queries against {n} vectors across {mesh.shape['model']} model ranks")
    print("top-3 of query 0:", ids[0][:3].tolist(), "scores", np.round(scores[0][:3], 3).tolist())
    print("OK — sharded == single-device, bit-exact")


if __name__ == "__main__":
    main()
