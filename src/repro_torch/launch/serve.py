"""Serving CLI: slot-based continuous batching over random weights.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-27b --full
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b --full
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-moe-16b --device cpu

The flags of ``repro.launch.serve`` plus ``--device`` (default ``cuda``).
Weights come from a ``torch.Generator`` seeded with 0 on that device; the
prompts from numpy's generator seeded with 0, ids in [2, vocab).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config, get_reduced
from ..models import api
from ..serve.server import Request, SlotServer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full else get_reduced(args.arch)
    if cfg.family in ("encdec",):
        raise SystemExit("slot server demo covers decoder-only archs")
    gen = torch.Generator(device=args.device).manual_seed(0)
    params = api.init_model(cfg, gen)
    rng = np.random.default_rng(0)
    reqs = [
        Request(rid=i, prompt=rng.integers(2, cfg.vocab, args.prompt_len).astype(np.int32),
                max_new_tokens=args.max_new)
        for i in range(args.requests)
    ]
    srv = SlotServer(params, cfg, n_slots=args.slots,
                     max_len=args.prompt_len + args.max_new + 8)
    t0 = time.perf_counter()
    srv.run(reqs)
    dt = time.perf_counter() - t0
    toks = sum(len(r.out_tokens) for r in reqs)
    print(f"served {len(reqs)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s, batch-slots={args.slots}, device={args.device}, "
          f"params={api.count_params(params)})")
    if not all(r.done for r in reqs):
        raise SystemExit("a request did not finish")


if __name__ == "__main__":
    main()
