"""Observability dump: trace + metrics + drift report from a live stream —
the counterpart of ``repro.launch.obsdump``.

    PYTHONPATH=src python -m repro_torch.launch.obsdump --n 5000 --queries 200
    PYTHONPATH=src python -m repro_torch.launch.obsdump --trace-out trace.json \\
        --probe-recall [--device cpu]

Builds a small KG-style service on ``--device`` ("cuda" unless told
otherwise; without a card it raises), with a write-ahead log in a temporary
directory, enables tracing, streams split 0's low-numbered templates, runs
one insert/delete + ``refresh()`` cycle, then streams the high-numbered
templates (the share shift the drift report should flag). It prints the
service's health, the unified metrics snapshot, the dispatch profiler's
table (``--profile``), the drift monitor's report, one index-evolution swap
record (``--tune``), and exports the Chrome-trace JSON — open it at
https://ui.perfetto.dev to see submit -> queue wait -> flush -> dispatch ->
merge -> WAL spans per query. The temporary directory is removed at the
end. ``main`` also returns what it printed, with the submitted and answered
query counts and the trace's span names.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
from typing import Any, Dict, Optional, Sequence

import numpy as np

from ..core import HQIConfig, HQIIndex
from ..core.workload import kg_style
from ..obs import trace
from ..obs.metrics import get_registry
from ..service import HQIService, ServiceConfig
from ..store.wal import WriteAheadLog


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=5000, help="database rows")
    ap.add_argument("--d", type=int, default=16, help="vector dims")
    ap.add_argument("--queries", type=int, default=200, help="stream length")
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--nprobe", type=int, default=8)
    ap.add_argument("--trace-out", default="trace.json")
    ap.add_argument("--profile", action="store_true",
                    help="run the kernel dispatch profiler alongside the "
                         "stream and print its roofline-attributed table")
    ap.add_argument("--probe-recall", action="store_true",
                    help="replay the answered-query reservoir against a "
                         "brute-force scan (exact recall@k; O(n) per sample)")
    ap.add_argument("--tune", action="store_true",
                    help="after the drift report, run one index-evolution "
                         "cycle: rebuild off to the side on the shifted "
                         "traffic and blue/green-swap the new generation in")
    ap.add_argument("--device", default="cuda", help="where the index and service run")
    args = ap.parse_args(argv)

    kg = kg_style(n=args.n, d=args.d, queries_per_split=args.queries, seed=0)
    wl = kg.splits[0]
    hqi = HQIIndex.build(
        kg.db, wl,
        HQIConfig(min_partition_size=max(128, args.n // 16), max_leaves=32),
        device=args.device,
    )
    tmp = tempfile.mkdtemp(prefix="obsdump_")
    wal = None
    out: Dict[str, Any] = {}
    try:
        wal = WriteAheadLog(os.path.join(tmp, "wal"))
        svc = HQIService(
            hqi,
            ServiceConfig(k=wl.k, nprobe=args.nprobe, max_batch=args.max_batch,
                          deadline_s=0.002),
            wal=wal,
        )
        tracer = trace.enable()
        prof = None
        if args.profile:
            from ..obs.profile import disable_profiler, enable_profiler

            prof = enable_profiler()

        # first half draws low-numbered templates, second half high-numbered:
        # the share shift the drift report should flag
        tcut = max(1, len(wl.templates) // 2)
        rows_a = np.where(wl.template_of < tcut)[0]
        rows_b = np.where(wl.template_of >= tcut)[0]
        if len(rows_a) == 0 or len(rows_b) == 0:
            rows_a, rows_b = np.arange(wl.m), np.arange(wl.m)

        handles = [svc.submit(wl.vectors[i], wl.templates[wl.template_of[i]]) for i in rows_a]
        svc.drain()

        rng = np.random.default_rng(1)
        n_new = max(8, args.n // 100)
        svc.insert(kg.db.vectors[rng.integers(0, kg.db.n, n_new)])
        svc.delete(rng.integers(0, kg.db.n, n_new // 2))
        svc.refresh()

        handles += [svc.submit(wl.vectors[i], wl.templates[wl.template_of[i]]) for i in rows_b]
        svc.drain()
        out["submitted"] = len(handles)
        out["answered"] = sum(1 for h in handles if h.ok)

        out["health"] = svc.health().as_dict()
        print("== health ==")
        print(json.dumps(out["health"], indent=2))

        metrics = get_registry().to_json(indent=2)
        out["metrics"] = json.loads(metrics)
        print("== metrics ==")
        print(metrics)

        if prof is not None:
            out["profile"] = prof.report()
            print("== profile ==")
            print(prof.format_table())
            disable_profiler()

        rep = svc.drift_report(probe_recall=args.probe_recall)
        out["drift"] = json.loads(rep.to_json())
        print("== drift ==")
        print(json.dumps(out["drift"], indent=2))

        if args.tune:
            from ..tuner import Tuner, TunerConfig

            tuner = Tuner(
                svc, tmp,
                cfg=TunerConfig(share_shift=0.2, min_window=32, retune_nprobe=False),
            )
            rec = tuner.tune_once()
            if rec is None:  # shift below threshold at this scale: swap anyway
                rec = tuner.tune_once(force=True)
            out["tuner"] = {
                "reason": rec.reason,
                "generation": rec.generation,
                "covered_seq": rec.covered_seq,
                "n_rows": rec.n_rows,
                "wal_tail_replayed": rec.replayed,
                "build_s": round(rec.build_s, 4),
                "swap_s": round(rec.swap_s, 4),
                "index_swaps": svc.health().index_swaps,
                "rollback_armed": tuner.can_rollback,
            }
            print("== tuner ==")
            print(json.dumps(out["tuner"], indent=2))

        path = tracer.export(args.trace_out)
        doc = tracer.to_chrome_trace()
        n_events = trace.validate_chrome_trace(doc)
        trace.disable()
        out["trace"] = {"path": path, "events": n_events, "spans": tracer.span_count,
                        "span_names": sorted({e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"})}
        print(f"== trace ==\n{n_events} events ({tracer.span_count} spans) "
              f"-> {path}  (open in https://ui.perfetto.dev)")
    finally:
        trace.disable()
        if wal is not None:
            wal.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


if __name__ == "__main__":
    main()
