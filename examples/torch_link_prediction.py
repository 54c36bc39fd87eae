"""Link prediction (LP) batch workload on PyTorch — the paper's second
industrial task.

No historical query log exists, so the workload-aware qd-tree is skipped and
the win comes purely from Algorithm-3 batching (attribute-template grouping
+ per-posting-list matmuls): the configuration the paper reports 19x for.

    PYTHONPATH=src python examples/torch_link_prediction.py [--device cpu] [--tiny]

The port's version of ``examples/link_prediction.py`` (on the card unless
``--device cpu``; ``--tiny``: 3,000 rows and 150 queries).
"""
import argparse
import time

from repro_torch.core import PreFilterIndex, exhaustive_search, recall_at_k, tune_nprobe
from repro_torch.core.workload import lp_style


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)

    n, n_queries = (3_000, 150) if args.tiny else (30_000, 1_500)
    db, workload = lp_style(n=n, d=32, n_queries=n_queries)
    truth = exhaustive_search(db, workload, device=args.device)
    index = PreFilterIndex.build(db, device=args.device)

    np_t = tune_nprobe(lambda w, np_: index.search(w, nprobe=np_, batch_vec=True), workload, truth)

    t0 = time.perf_counter()
    res_b = index.search(workload, nprobe=np_t, batch_vec=True)   # Algorithm 3
    t_batch = time.perf_counter() - t0

    t0 = time.perf_counter()
    res_s = index.search(workload, nprobe=np_t, batch_vec=False)  # per-query scans
    t_single = time.perf_counter() - t0

    t0 = time.perf_counter()
    res_1 = index.search(workload, nprobe=np_t, batch_attr=False)  # one-at-a-time
    t_one = time.perf_counter() - t0

    print(f"one-at-a-time:       {t_one*1e3:8.1f} ms   recall={recall_at_k(res_1, truth):.2f}")
    print(f"attr-batched:        {t_single*1e3:8.1f} ms   recall={recall_at_k(res_s, truth):.2f}")
    print(f"attr+vector batched: {t_batch*1e3:8.1f} ms   recall={recall_at_k(res_b, truth):.2f}")
    print(f"batching speedup vs one-at-a-time: {t_one/t_batch:.1f}x")
    assert recall_at_k(res_b, truth) >= 0.8
    print("OK")


if __name__ == "__main__":
    main()
