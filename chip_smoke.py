#!/usr/bin/env python3
"""On-card smoke of the PyTorch/H100 port (``src/repro_torch``).

    python3 chip_smoke.py            # all phases, one CUDA card

1. device and build: the card's name and power limit; every CUDA kernel
   built from ``src/repro_torch/kernels/csrc`` with nvcc (timed);
2. kernels against their plain PyTorch versions on the card: both
   ``fused_knn`` grids at W=256, TQ=64, D=64, k=10, TV in {32..4096}, ip and
   l2, f32 and bf16, valid density 0.7, plus all-invalid and k above the
   valid count; scores within rtol/atol 1e-4 (f32) or 2e-2 (bf16), ids equal
   wherever scores are untied; kernel, plain version and the yardstick
   (``torch.matmul`` + masked ``torch.topk``) timed with CUDA events
   (median of 25) beside each shape's bound;
3. the main path at real size: ``kg_style(n=1_000_000, d=64,
   queries_per_split=10_000)``, ``HQIIndex.build`` on the card, then
   ``search(nprobe=8)`` (once cold, three times warm); the kernels' launch
   counters are zeroed just before the last warm search and read just after
   it, and both must be > 0 while the plain version's call count stays 0
   (the ``launches`` of the kernels line are per search). Every returned id must pass its
   query's filter with its exact score; recall@10 against the port's
   ``exhaustive_search``; one more search with the tracer on and one under
   ``torch.profiler`` split the time. Then each kernel is checked on every
   bucket the main path gave it and timed on the heaviest;
4. card against CPU: a 100k-row index built on the card, reloaded from its
   ``to_state()`` on the CPU; both searches must agree (scores within
   1e-4, equal id sets per query);
5. the ``kernels`` JSON line, the ``nvidia-smi`` line, and last the result
   line ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no result
line. It writes its full record (and nvcc's log) under ``--out``
(default ``smoke_out/``).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS_PER_S = 67e12  # H100 SXM, CUDA cores (no tensor cores)
MAIN_ROWS, MAIN_QUERIES = 1_000_000, 10_000  # the main path's kg_style size
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/fused_knn.cu"
REPLACES = {
    "fused_knn": "src/repro/kernels/fused_knn.py:224",
    "fused_knn_db_stationary": "src/repro/kernels/fused_knn.py:165",
}
NEG_INF = -3.4e38


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event-timed calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(q, v, valid, k: int, metric: str, q_live=None) -> tuple[float, str]:
    """Least time (ms) for the function on these inputs, counting only what
    this data needs. Bytes over HBM: the vectors of the real query slots
    (``q_live``, bool [W, TQ]; every slot by default) and of the valid rows
    read once, the mask of each unit holding a real query read once, the
    real slots' top-k written once. Operations over the fp32 peak: each
    unit's real queries against its valid rows (and the l2 norms). The larger
    of the two."""
    import torch

    W, TQ, D = q.shape
    TV = v.shape[1]
    if q_live is None:
        q_live = torch.ones((W, TQ), dtype=torch.bool, device=q.device)
    nq_w = q_live.sum(1).double()
    nv_w = valid.sum(1).double()
    n_q, n_v = float(nq_w.sum()), float(nv_w.sum())
    n_units = int((nq_w > 0).sum())
    nbytes = (n_q * D * q.element_size() + n_v * D * v.element_size()
              + n_units * TV * valid.element_size() + n_q * k * 8)
    flops = 2.0 * D * float((nq_w * nv_w).sum())
    if metric == "l2":
        flops += 2.0 * D * (n_q + n_v)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def yardstick(q, v, valid, k: int, metric: str):
    """``torch.matmul`` + masked ``torch.topk``: the library's way to the same
    top-k (tie order aside), timed beside the kernels and used nowhere else."""
    import torch

    qf, vf = q.float(), v.float()
    s = torch.matmul(qf, vf.transpose(1, 2))
    if metric == "l2":
        s = 2.0 * s - (qf * qf).sum(-1, keepdim=True) - (vf * vf).sum(-1)[:, None, :]
    s = s.masked_fill(~valid[:, None, :], NEG_INF)
    return torch.topk(s, k, dim=-1)


def compare(got, want, tol: float) -> float:
    """Scores within rtol/atol ``tol``; ids equal at every untied position;
    the same slots absent (-1). Returns the largest absolute score error."""
    gs = got[0].cpu().numpy().astype(np.float64)
    gi = got[1].cpu().numpy()
    ws = want[0].cpu().numpy().astype(np.float64)
    wi = want[1].cpu().numpy()
    if gs.shape != ws.shape or gi.shape != wi.shape:
        raise AssertionError(f"shape {gs.shape} vs {ws.shape}")
    np.testing.assert_allclose(gs, ws, rtol=tol, atol=tol)
    if not np.array_equal(gi < 0, wi < 0):
        raise AssertionError("absent slots differ")
    gap = tol * (1.0 + np.abs(ws))
    near_prev = np.zeros(ws.shape, bool)
    near_prev[..., 1:] = np.abs(ws[..., 1:] - ws[..., :-1]) <= gap[..., 1:]
    near_next = np.zeros(ws.shape, bool)
    near_next[..., :-1] = near_prev[..., 1:]
    # the last slot may tie with the first row left out: treat it as tied
    untied = ~(near_prev | near_next) & (wi >= 0)
    untied[..., -1] = False
    bad = untied & (gi != wi)
    if bad.any():
        raise AssertionError(f"{int(bad.sum())} untied ids differ")
    live = wi >= 0
    return float(np.abs(gs - ws)[live].max()) if live.any() else 0.0


# ---------------------------------------------------------------- phases


def phase_build(rec: dict, out_dir: str) -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    rec["build_seconds"] = time.perf_counter() - t0
    log(f"[build] kernels built in {rec['build_seconds']:.3f} s")
    with open(os.path.join(out_dir, "nvcc_build.log"), "w") as f:
        for name, text in _build.build_log.items():
            f.write(f"== {name}\n{text}\n")
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def phase_kernels(rec: dict, max_err: dict) -> None:
    import torch

    from repro_torch.kernels.fused_knn import fused_knn, fused_knn_db_stationary, fused_knn_plain

    kernels = {"fused_knn": fused_knn, "fused_knn_db_stationary": fused_knn_db_stationary}
    gen = torch.Generator(device="cuda").manual_seed(0)
    W, TQ, D, K = 256, 64, 64, 10
    rows = []

    def run_case(label, q, v, valid, k, metric, tol, timed):
        want = fused_knn_plain(q, v, valid, k=k, metric=metric)
        row = {"case": label, "W": q.shape[0], "TQ": q.shape[1], "TV": v.shape[1],
               "D": q.shape[2], "k": k, "metric": metric, "dtype": str(q.dtype)}
        for name, fn in kernels.items():
            got = fn(q, v, valid, k=k, metric=metric)
            torch.cuda.synchronize()
            err = compare(got, want, tol)
            max_err[name] = max(max_err[name], err)
            row[f"{name}_err"] = err
            if timed:
                row[f"{name}_ms"] = cuda_ms(lambda: fn(q, v, valid, k=k, metric=metric))
        if timed:
            row["plain_ms"] = cuda_ms(lambda: fused_knn_plain(q, v, valid, k=k, metric=metric))
            row["yardstick_ms"] = cuda_ms(lambda: yardstick(q, v, valid, k, metric))
            row["bound_ms"], row["bound_by"] = bound(q, v, valid, k, metric)
        rows.append(row)
        log("[kernels] " + json.dumps(row))

    for tv in (32, 128, 256, 1024, 4096):
        for metric in ("ip", "l2"):
            for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
                q = torch.randn((W, TQ, D), generator=gen, device="cuda").to(dtype)
                v = torch.randn((W, tv, D), generator=gen, device="cuda").to(dtype)
                valid = torch.rand((W, tv), generator=gen, device="cuda") < 0.7
                run_case("sweep", q, v, valid, K, metric, tol, timed=True)
    q = torch.randn((W, TQ, D), generator=gen, device="cuda")
    v = torch.randn((W, 256, D), generator=gen, device="cuda")
    run_case("all_invalid", q, v, torch.zeros((W, 256), dtype=torch.bool, device="cuda"),
             K, "ip", 1e-4, timed=False)
    v = torch.randn((W, 1024, D), generator=gen, device="cuda")
    few = torch.zeros((W, 1024), dtype=torch.bool, device="cuda")
    few[:, [3, 700, 1001]] = True
    run_case("k_above_valid", q, v, few, K, "l2", 1e-4, timed=False)
    # a unit with 2 valid rows of 1024 and k=4: the unfilled slots are (NEG_INF, -1)
    two = torch.zeros((W, 1024), dtype=torch.bool, device="cuda")
    two[:, [3, 700]] = True
    for name, fn in kernels.items():
        s, i = fn(q, v, two, k=4, metric="ip")
        ids = i.cpu().numpy()
        if not ((ids[..., 2:] == -1).all() and (s[..., 2:].cpu().numpy() == np.float32(NEG_INF)).all()
                and set(np.unique(ids[..., :2]).tolist()) == {3, 700}):
            raise AssertionError(f"{name}: unfilled slots are not (NEG_INF, -1)")
    rec["kernel_cases"] = rows


def phase_main_path(rec: dict) -> dict:
    import torch

    from repro_torch.core import HQIConfig, HQIIndex, exhaustive_search, kg_style, recall_at_k
    from repro_torch.core.predicates import evaluate_filter
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_knn import fused_knn, fused_knn_db_stationary, fused_knn_plain

    n, queries = MAIN_ROWS, MAIN_QUERIES
    t0 = time.perf_counter()
    kg = kg_style(n=n, d=64, queries_per_split=queries, seed=0)
    wl = kg.splits[1]
    log(f"[main] kg_style(n={n}, d=64, queries_per_split={queries}) made in "
        f"{time.perf_counter() - t0:.3f} s; vectors {kg.db.vectors.nbytes / 2**20:.1f} MiB")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    index = HQIIndex.build(kg.db, kg.splits[0], HQIConfig(), device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    times = []
    for i in range(4):  # one cold (arena upload), three warm; the last one is counted
        if i == 3:
            fused_knn.launches = fused_knn_db_stationary.launches = fused_knn_plain.calls = 0
            ops.reset_dispatch_stats()
        t0 = time.perf_counter()
        res = index.search(wl, nprobe=8)
        times.append(time.perf_counter() - t0)
    counts = {"fused_knn": fused_knn.launches,
              "fused_knn_db_stationary": fused_knn_db_stationary.launches,
              "plain": fused_knn_plain.calls}
    st = ops.dispatch_stats().snapshot()
    warm_s = statistics.median(times[1:])
    peak = torch.cuda.max_memory_allocated()
    log(f"[main] build {build_s:.3f} s ({index.build_info}); {len(index.partitions)} partitions")
    log(f"[main] search cold {times[0]:.3f} s, warm {[round(t, 4) for t in times[1:]]} s: "
        f"{wl.m / warm_s:.1f} queries/s warm (median)")
    log(f"[main] one warm search: launches {counts}; dispatch knn_calls={st.knn_calls} "
        f"merge_calls={st.merge_calls} shapes={sorted(st.shapes)} "
        f"peak_candidate_bytes={st.peak_candidate_bytes}; peak device memory {peak / 2**30:.2f} GiB")
    if counts["fused_knn"] <= 0 or counts["fused_knn_db_stationary"] <= 0:
        raise AssertionError(f"a kernel of the main path was never launched: {counts}")
    if counts["plain"] != 0:
        raise AssertionError(f"the plain version ran on the main path: {counts}")

    # every returned id passes its query's filter and carries its exact score
    ids, scores = res.ids, res.scores
    if ids.shape != (wl.m, wl.k) or scores.shape != (wl.m, wl.k):
        raise AssertionError(f"result shape {ids.shape}")
    live = ids >= 0
    if not np.isfinite(scores[live]).all() or np.isfinite(scores[~live]).any():
        raise AssertionError("scores not finite exactly where ids are present")
    ok = np.zeros_like(live)
    for ti, filt in enumerate(wl.templates):
        qi = wl.queries_for_template(ti)
        bm = evaluate_filter(filt, kg.db)
        ok[qi] = bm[np.maximum(ids[qi], 0)]
    if not ok[live].all():
        raise AssertionError("a returned id fails its query's filter")
    rows = kg.db.vectors[np.maximum(ids, 0)]  # [m, k, d]
    exact = np.einsum("qd,qkd->qk", wl.vectors, rows)
    if kg.db.metric == "l2":
        exact = 2.0 * exact - (wl.vectors ** 2).sum(1)[:, None] - (rows ** 2).sum(2)
    np.testing.assert_allclose(scores[live], exact[live], rtol=1e-4, atol=1e-4)
    for r in range(wl.m):
        row = ids[r][ids[r] >= 0]
        if len(np.unique(row)) != len(row):
            raise AssertionError(f"duplicate ids in row {r}")

    t0 = time.perf_counter()
    truth = exhaustive_search(kg.db, wl, device="cuda")
    exh_s = time.perf_counter() - t0
    recall = recall_at_k(res, truth)
    log(f"[main] recall@10 {recall:.4f} against exhaustive_search ({exh_s:.3f} s)")

    # where the search's time goes: one more run with the tracer on (fenced spans)
    from repro_torch.obs import trace

    tracer = trace.enable()
    t0 = time.perf_counter()
    index.search(wl, nprobe=8)
    traced_s = time.perf_counter() - t0
    trace.disable()
    spans: dict = {}
    for ev in tracer.events():
        if ev.get("ph") == "X":
            spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur"] / 1e3
    log(f"[main] traced search {traced_s:.3f} s; span ms {json.dumps(spans)}")

    # device busy share: kernel time in a torch.profiler trace of one search
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        index.search(wl, nprobe=8)
        prof_s = time.perf_counter() - t0
    kernel_us: dict = {}  # device-side events only (kernels, copies, memsets)
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            kernel_us[ev.key] = ev.self_device_time_total
    busy_s = sum(kernel_us.values()) / 1e6
    top = sorted(kernel_us.items(), key=lambda kv: -kv[1])[:8]
    log(f"[main] profiled search {prof_s:.3f} s, device busy {busy_s * 1e3:.3f} ms "
        f"({busy_s / prof_s:.2%}); top device ops (ms) "
        + json.dumps({k[:60]: v / 1e3 for k, v in top}))

    rec["main_path"] = {
        "n": n, "d": 64, "queries": wl.m, "partitions": len(index.partitions),
        "build_seconds": build_s, "build_info": str(index.build_info),
        "search_seconds_cold": times[0], "search_seconds_warm": times[1:],
        "qps_warm": wl.m / warm_s, "recall_at_10": recall,
        "exhaustive_seconds": exh_s, "launches": counts,
        "knn_calls": st.knn_calls, "merge_calls": st.merge_calls,
        "shapes": sorted(st.shapes), "peak_candidate_bytes": st.peak_candidate_bytes,
        "peak_device_bytes": peak, "traced_search_seconds": traced_s, "span_ms": spans,
        "profiled_search_seconds": prof_s, "device_busy_seconds": busy_s,
        "device_ops_ms": {k: v / 1e3 for k, v in top},
    }
    return {"index": index, "wl": wl, "counts": counts}


def phase_main_shapes(rec: dict, main: dict, max_err: dict) -> dict:
    """Each kernel on every bucket the main path gave it: checked against the
    plain version, and timed (kernel, plain, yardstick) on its heaviest."""
    import torch

    from repro_torch.core.ivf import ScanStats
    from repro_torch.core.plan import build_plan
    from repro_torch.core.planner import bucket_operands
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_knn import fused_knn, fused_knn_db_stationary, fused_knn_plain

    index, wl = main["index"], main["wl"]
    tasks, _, _ = index._engine_tasks(wl, nprobe=8, batch_vec=True, stats=ScanStats())
    plan = build_plan(index.arena, tasks, wl.vectors, m=wl.m, k=wl.k, cfg=index.cfg.plan)
    q_dev = torch.from_numpy(wl.vectors).cuda()
    metric = index.arena.metric
    per_kernel: dict = {}
    buckets = []
    for lp in sorted(plan.buckets):
        qrow_of, _, _, Q, V, valid = bucket_operands(plan, index.arena, q_dev, lp)
        q_live = torch.from_numpy(qrow_of >= 0).cuda()
        k = min(wl.k, lp)
        name = "fused_knn_db_stationary" if ops.use_db_stationary(Q.shape[1], lp) else "fused_knn"
        fn = fused_knn_db_stationary if name == "fused_knn_db_stationary" else fused_knn
        got = fn(Q, V, valid, k=k, metric=metric)
        want = fused_knn_plain(Q, V, valid, k=k, metric=metric)
        err = compare(got, want, 1e-4)
        max_err[name] = max(max_err[name], err)
        ms = cuda_ms(lambda: fn(Q, V, valid, k=k, metric=metric), reps=21)
        b_ms, b_by = bound(Q, V, valid, k, metric, q_live)
        row = {"kernel": name, "shape": [Q.shape[0], Q.shape[1], lp, k], "ms": ms,
               "bound_ms": b_ms, "bound_by": b_by, "ms_over_bound": ms / b_ms,
               "max_abs_err": err, "valid_rows": int(valid.sum().item()),
               "real_query_slots": int(q_live.sum().item())}
        buckets.append(row)
        log("[shapes] " + json.dumps(row))
        work = Q.shape[0] * lp
        if name not in per_kernel or work > per_kernel[name]["work"]:
            per_kernel[name] = {"work": work, "Q": Q, "V": V, "valid": valid, "k": k, "row": row}
        else:
            del Q, V, valid, q_live
    out = {}
    for name, sel in per_kernel.items():
        Q, V, valid, k = sel["Q"], sel["V"], sel["valid"], sel["k"]
        row = dict(sel["row"])
        row["plain_ms"] = cuda_ms(lambda: fused_knn_plain(Q, V, valid, k=k, metric=metric), reps=21)
        row["yardstick_ms"] = cuda_ms(lambda: yardstick(Q, V, valid, k, metric), reps=21)
        out[name] = row
        log("[heaviest] " + json.dumps(row))
    rec["main_path_buckets"] = buckets
    rec["main_path_heaviest"] = out
    return out


def phase_card_vs_cpu(rec: dict) -> None:
    from repro_torch.core import HQIConfig, HQIIndex, kg_style

    kg = kg_style(n=100_000, d=64, seed=0)
    wl = kg.splits[1]
    gpu = HQIIndex.build(kg.db, kg.splits[0], HQIConfig(), device="cuda")
    cpu = HQIIndex.from_state(gpu.to_state(), device="cpu")
    a = gpu.search(wl, nprobe=8)
    t0 = time.perf_counter()
    b = cpu.search(wl, nprobe=8)
    cpu_s = time.perf_counter() - t0
    np.testing.assert_allclose(
        np.where(np.isfinite(a.scores), a.scores, -1e30),
        np.where(np.isfinite(b.scores), b.scores, -1e30), rtol=1e-4, atol=1e-4,
    )
    for r in range(wl.m):
        if set(a.ids[r][a.ids[r] >= 0].tolist()) != set(b.ids[r][b.ids[r] >= 0].tolist()):
            raise AssertionError(f"card and CPU disagree on query {r}")
    rec["card_vs_cpu"] = {"n": 100_000, "queries": wl.m, "cpu_search_seconds": cpu_s,
                          "agree": True}
    log(f"[card-vs-cpu] {wl.m} queries on a 100k-row index agree (CPU search {cpu_s:.3f} s)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "smoke_out"), help="record directory")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    if "jax" in sys.modules or "repro" in sys.modules:
        raise AssertionError("the port pulled in jax or the reference package")
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 products in full fp32
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    log(f"[device] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    os.makedirs(args.out, exist_ok=True)
    t_start = time.perf_counter()
    rec: dict = {"nvidia_smi": smi, "torch": torch.__version__}
    max_err = {"fused_knn": 0.0, "fused_knn_db_stationary": 0.0}

    phase_build(rec, args.out)
    phase_kernels(rec, max_err)
    main_run = phase_main_path(rec)
    heaviest = phase_main_shapes(rec, main_run, max_err)
    del main_run["index"]
    torch.cuda.empty_cache()
    phase_card_vs_cpu(rec)

    kernels = []
    for name in ("fused_knn", "fused_knn_db_stationary"):
        h = heaviest[name]
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE, "replaces": REPLACES[name],
            "launches": main_run["counts"][name], "max_abs_err": max_err[name],
            "ms": h["ms"], "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
            "bound_by": h["bound_by"], "library_ms": None,
            "ms_over_bound": h["ms_over_bound"], "yardstick_ms": h["yardstick_ms"],
            "shape": h["shape"],
        })
    rec["kernels"] = kernels
    rec["seconds"] = time.perf_counter() - t_start
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump(rec, f, indent=1, default=str)
    log(f"[done] all phases passed in {rec['seconds']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
