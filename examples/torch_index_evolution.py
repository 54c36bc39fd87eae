"""Index evolution walkthrough on PyTorch: drift-triggered rebuild +
blue/green hot swap.

    PYTHONPATH=src python examples/torch_index_evolution.py [--device cpu]

The port's version of ``examples/index_evolution.py`` (on the card unless
``--device cpu``). Serves a KG-style query stream whose template mix shifts
mid-stream, lets the Tuner detect the drift and rebuild the qd-tree off to
the side on the live traffic, then blue/green-swaps the new generation in —
with writes landing throughout, zero dropped queries, and an instant
rollback path.
"""
import argparse
import shutil
import tempfile

import numpy as np

from repro_torch.core import HQIConfig, HQIIndex
from repro_torch.core.workload import kg_style
from repro_torch.service import ServiceConfig
from repro_torch.store import init_store, list_generations, pinned_generations
from repro_torch.store.snapshot import current_generation
from repro_torch.tuner import Tuner, TunerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)

    # --- a KG-style service, persisted (snapshot + WAL) -----------------------
    kg = kg_style(n=6_000, d=32, queries_per_split=160, seed=0)
    wl_early, wl_late = kg.splits[0], kg.splits[3]
    hqi = HQIIndex.build(
        kg.db, wl_early, HQIConfig(min_partition_size=256, max_leaves=32), device=args.device
    )
    root = tempfile.mkdtemp(prefix="hqi_evolve_")
    svc = init_store(root, hqi, cfg=ServiceConfig(k=10, nprobe=8, max_batch=32), device=args.device)
    tuner = Tuner(svc, root, cfg=TunerConfig(share_shift=0.3, min_window=32))

    def stream(wl, rows):
        handles = [
            svc.submit(wl.vectors[i], wl.templates[wl.template_of[i]]) for i in rows
        ]
        svc.drain()
        assert all(h.ok for h in handles), "no query may be dropped"
        return handles

    # 1) the early era: selective head templates dominate; the tuner sees a
    #    stationary mix and does nothing
    stream(wl_early, np.where(wl_early.template_of <= 4)[0])
    assert tuner.tune_once() is None
    print(f"early era served; drift share_shift "
          f"{svc.drift_report().share_shift:.2f} -> no rebuild")

    # 2) the mix shifts: broad templates take over, and writes keep landing
    #    (they are what the swap's WAL-tail replay must carry across)
    acked = svc.insert(kg.db.vectors[rng.integers(0, kg.db.n, 40)])
    stream(wl_late, np.where(wl_late.template_of >= 5)[0])

    # 3) one tuner cycle: capture -> rebuild off to the side (serving continues)
    #    -> persist the candidate generation -> drain + swap -> promote + pin
    rec = tuner.tune_once()
    assert rec is not None
    print(f"drift tripped ({rec.reason}): rebuilt {rec.n_rows} rows in "
          f"{rec.build_s:.2f}s, swapped in {rec.swap_s*1e3:.1f}ms as "
          f"{rec.generation}, WAL tail replayed {rec.replayed} records")
    print(f"generations on disk: {list_generations(root)}; current "
          f"{current_generation(root)}; pinned for rollback {sorted(pinned_generations(root))}")

    # 4) the acknowledged writes survived the swap, and the stream never stopped
    h = svc.submit(kg.db.vectors[int(acked[0]) % kg.db.n], wl_late.templates[9])
    svc.drain()
    assert svc.health().index_swaps == 1
    print(f"post-swap health: swaps={svc.health().index_swaps}, "
          f"queries still answering (h.ok={h.ok})")

    # 5) instant rollback keeps even post-swap writes (in production you'd
    #    instead forget_rollback() once the new layout proves itself out)
    post = svc.insert(kg.db.vectors[:3])
    tuner.rollback()
    assert svc.health().index_swaps == 2
    h = svc.submit(kg.db.vectors[0], wl_late.templates[9])
    svc.drain()
    assert h.ok
    print(f"rolled back to {current_generation(root)}; post-swap insert "
          f"{[int(i) for i in post]} still live; zero queries dropped end-to-end")

    if svc.wal is not None:
        svc.wal.close()
    shutil.rmtree(root)
    print("OK")


if __name__ == "__main__":
    main()
