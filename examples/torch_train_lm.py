"""End-to-end training script on PyTorch: train a ~100M-param LM for a few
hundred steps with the full production loop — microbatched train step, WSD
schedule, async checkpointing, restart-safe deterministic data.

    PYTHONPATH=src python examples/torch_train_lm.py            # ~100M params
    PYTHONPATH=src python examples/torch_train_lm.py --tiny     # CI-speed
    PYTHONPATH=src python examples/torch_train_lm.py --tiny --device cpu

The port's version of ``examples/train_lm.py`` (on the card unless
``--device cpu``). Its checkpoints live in a directory of the port's own
under ``default_ckpt_dir()`` (one per config): the port's checkpoint keys
name the layer, so a reference checkpoint is never restored.
"""
import argparse
import os

from repro_torch.configs import get_reduced
from repro_torch.data.pipeline import DataConfig
from repro_torch.models import api
from repro_torch.models.transformer import ModelConfig
from repro_torch.train.fault_tolerance import LoopConfig, TrainLoop, default_ckpt_dir
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import TrainConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.tiny:
        cfg = get_reduced("minicpm-2b")
        steps = args.steps or 30
        batch, seq = 8, 32
    else:
        # ~100M-param llama-style LM (minicpm family wiring, scaled down)
        cfg = ModelConfig(
            name="lm-100m", family="dense", n_layers=12, d_model=768, n_heads=12,
            n_kv_heads=12, d_ff=2048, vocab=32_000, q_chunk=256, kv_chunk=256,
        )
        steps = args.steps or 300
        batch, seq = 16, 256

    tcfg = TrainConfig(
        opt=OptConfig(name="adamw", schedule="wsd", peak_lr=3e-4,
                      warmup_steps=max(10, steps // 20), total_steps=steps),
        microbatches=2,
    )
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch)
    ckpt_dir = os.path.join(default_ckpt_dir(), f"train_lm_{cfg.name}{'_tiny' if args.tiny else ''}")
    loop = TrainLoop(cfg, tcfg, dcfg,
                     LoopConfig(ckpt_dir=ckpt_dir, ckpt_every=max(50, steps // 4),
                                log_every=max(1, steps // 20)),
                     device=args.device)
    n_params = api.count_params(loop.state["params"])
    print(f"model: {cfg.name}  params={n_params/1e6:.1f}M  device={loop.device}")
    loop.maybe_restore()
    hist = loop.run(steps)
    first, last = hist[0]["loss"], hist[-1]["loss"]
    print(f"loss: {first:.3f} -> {last:.3f} over {steps} steps")
    assert last < first, "training must reduce the loss"
    print("OK")


if __name__ == "__main__":
    main()
