"""End-to-end training entry point.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b --reduced \
        --steps 200 --batch 16 --seq 128 [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch kimi-k2-1t-a32b --reduced --device cpu

The flags of ``repro.launch.train`` plus ``--device`` (default ``cuda``).
Runs the resilient ``TrainLoop`` (checkpoint/restart, retries,
deterministic data) on that device, with the arch's optimizer and schedule
(``configs.optimizer_for``, ``schedule_for``) and f32 master weights; prints
the last three logged steps' metrics as JSON.
"""
from __future__ import annotations

import argparse
import json
import logging

from ..configs import get_config, get_reduced, optimizer_for, schedule_for
from ..data.pipeline import DataConfig
from ..train.fault_tolerance import LoopConfig, TrainLoop, default_ckpt_dir
from ..train.optimizer import OptConfig
from ..train.train_step import TrainConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", help="smoke-scale config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=default_ckpt_dir())
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    opt = OptConfig(
        name=optimizer_for(args.arch),
        schedule=schedule_for(args.arch),
        peak_lr=args.lr,
        warmup_steps=max(10, args.steps // 20),
        total_steps=args.steps,
    )
    tcfg = TrainConfig(opt=opt, microbatches=args.microbatches)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch)
    loop = TrainLoop(
        cfg, tcfg, dcfg,
        LoopConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every),
        device=args.device,
    )
    if args.resume:
        loop.maybe_restore()
    hist = loop.run(args.steps)
    print(json.dumps(hist[-3:], indent=1))
    return hist


if __name__ == "__main__":
    main()
