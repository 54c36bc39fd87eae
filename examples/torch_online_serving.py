"""Online serving walkthrough on PyTorch: stream hybrid queries with live
inserts/deletes.

    PYTHONPATH=src python examples/torch_online_serving.py [--device cpu]

The port's version of ``examples/online_serving.py`` (on the card unless
``--device cpu``). Builds an HQI over a toy KG, wraps it in HQIService, and
walks the serving lifecycle: micro-batched queries, an insert visible to the
very next flush, a tombstone delete, a refresh() that folds the delta into
the index partitions without a rebuild, a crash and recovery through the
store, and a traced burst (its Chrome trace written under the temporary
directory).
"""
import argparse
import os
import shutil
import tempfile

import numpy as np

from repro_torch.core import (
    Column, Contains, HQIConfig, HQIIndex, NotNull, VectorDatabase, Workload, make_filter,
)
from repro_torch.obs import trace
from repro_torch.obs.metrics import get_registry
from repro_torch.service import HQIService, ServiceConfig
from repro_torch.store import init_store, open_service


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
    height = Column.numeric(
        "height", rng.random(n), null_mask=(type_of != 0) | (rng.random(n) < 0.2)
    )
    db = VectorDatabase(
        vectors=vectors,
        columns={"type": Column.setcat("type", membership), "height": height},
        metric="ip",
    )

    # --- historical workload sample (what the qd-tree is mined from) ----------
    person_with_height = make_filter(Contains("type", 0), NotNull("height"))
    any_song = make_filter(Contains("type", 1))
    hist = rng.integers(0, n, 200)
    sample = Workload(
        vectors=vectors[hist] + 0.05 * rng.normal(size=(200, d)).astype(np.float32),
        templates=[person_with_height, any_song],
        template_of=(hist % 2).astype(np.int32),
        k=10,
    )
    hqi = HQIIndex.build(db, sample, HQIConfig(min_partition_size=512, max_leaves=16), device=args.device)

    # --- wrap it in a service: flush every 64 queries or 5 ms -----------------
    svc = HQIService(
        hqi,
        ServiceConfig(k=10, nprobe=8, max_batch=64, deadline_s=0.005, queue_bound=1024),
    )

    # 1) stream a burst of online queries and flush
    handles = [
        svc.submit(vectors[int(e)] + 0.05 * rng.normal(size=d).astype(np.float32),
                   person_with_height if e % 2 == 0 else any_song)
        for e in rng.integers(0, n, 96)
    ]
    answered = svc.drain()
    ids0, scores0 = handles[0].result()
    print(f"answered {answered} queries; first query's top-3 ids: {ids0[:3].tolist()}")

    # 2) insert a brand-new "Person" entity right next to an existing vector —
    #    it must appear in the next flush's answers (no rebuild, no refresh)
    probe_vec = vectors[0]
    new_ids = svc.insert(
        probe_vec[None, :],
        columns={"type": np.eye(n_types, dtype=bool)[0][None, :],
                 "height": np.array([0.5], dtype=np.float32)},
    )
    h = svc.submit(probe_vec, person_with_height)
    svc.drain()
    assert int(new_ids[0]) in h.ids.tolist(), "live insert must be served immediately"
    print(f"inserted id {int(new_ids[0])} surfaced in the very next flush")

    # 3) tombstone it again — gone from the following flush
    svc.delete(new_ids)
    h = svc.submit(probe_vec, person_with_height)
    svc.drain()
    assert int(new_ids[0]) not in h.ids.tolist(), "tombstoned row must disappear"
    print("tombstoned the insert; it no longer appears")

    # 4) refresh(): fold buffered rows into the index partitions incrementally
    svc.insert(np.repeat(probe_vec[None, :], 5, axis=0))
    folded = svc.refresh()
    print(f"refresh folded {folded} rows into {len(hqi.partitions)} partitions "
          f"(db is now {hqi.db.n} tuples; no rebuild)")

    # 5) telemetry
    s = svc.telemetry.summary()
    print(f"served {s['queries']:.0f} queries in {s['flushes']:.0f} flushes; "
          f"p50 {s['p50_latency_s']*1e3:.1f} ms, p99 {s['p99_latency_s']*1e3:.1f} ms, "
          f"{s['merge_dispatches_per_flush']:.1f} merge dispatches/flush")

    # 6) persistence: save -> "kill" -> recover -> verify (repro_torch.store)
    #    init_store snapshots the (refreshed) index and attaches a WAL, so every
    #    insert/delete is durable BEFORE it is acknowledged
    root = tempfile.mkdtemp(prefix="hqi_store_")
    store_svc = init_store(root, hqi, device=args.device)
    acked = store_svc.insert(
        probe_vec[None, :],
        columns={"type": np.eye(n_types, dtype=bool)[0][None, :],
                 "height": np.array([0.7], dtype=np.float32)},
    )
    h = store_svc.submit(probe_vec, person_with_height)
    store_svc.drain()
    before_ids, before_scores = h.ids.copy(), h.scores.copy()
    store_svc.wal.close()
    del store_svc  # "kill -9": the delta buffer lived only in RAM — and the WAL

    # 7) warm restart: load the snapshot, replay the WAL tail, resume serving
    recovered = open_service(root, device=args.device)
    h = recovered.submit(probe_vec, person_with_height)
    recovered.drain()
    assert int(acked[0]) in h.ids.tolist(), "acknowledged insert must survive"
    assert np.array_equal(before_ids, h.ids) and np.array_equal(before_scores, h.scores), \
        "recovery must answer bit-identically to the uncrashed process"
    print(f"recovered from {root}: acknowledged insert {int(acked[0])} survived "
          f"the crash; answers bit-identical to the uncrashed service")
    recovered.wal.close()
    shutil.rmtree(root)

    # 8) observability: re-run a traced burst and export a Perfetto-loadable
    #    timeline — submit markers, per-query queue waits, flush/dispatch/merge
    #    spans — plus the unified metrics snapshot and a workload-drift reading
    tracer = trace.enable()  # tracing is off by default and costs nothing until now
    handles = [
        svc.submit(vectors[int(e)] + 0.05 * rng.normal(size=d).astype(np.float32),
                   person_with_height if e % 2 == 0 else any_song)
        for e in rng.integers(0, n, 64)
    ]
    svc.drain()
    trace_path = tracer.export(os.path.join(tempfile.mkdtemp(prefix="hqi_trace_"), "trace.json"))
    trace.disable()
    snap = get_registry().snapshot()
    rep = svc.drift_report()
    print(f"traced {tracer.span_count} spans -> {trace_path} "
          f"(open in https://ui.perfetto.dev); "
          f"queue-wait p50 {snap['service.queue_wait_s']['p50']*1e3:.2f} ms; "
          f"drift share_shift {rep.share_shift:.2f} over {rep.n_window} queries")
    print("OK")


if __name__ == "__main__":
    main()
