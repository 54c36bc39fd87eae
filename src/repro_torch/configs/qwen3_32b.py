"""qwen3-32b [dense] — GQA kv=8 with per-head q/k RMSNorm (hf:Qwen/Qwen3-*)."""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab=151936,
    rope_theta=1e6,
    qk_norm=True,
)


def reduced() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, q_chunk=32, kv_chunk=32,
    )
