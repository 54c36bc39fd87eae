"""gemma3-27b [dense] — 5:1 local:global attention, 128k context

(hf:google/gemma-3-*). Sliding window 1024 on local layers."""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab=262144,
    rope_theta=1e6,
    window_pattern=(1024, 1024, 1024, 1024, 1024, 0),  # 5 local : 1 global
    embed_scale=True,
)


def reduced() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, window_pattern=(16, 16, 16, 16, 16, 0),
        q_chunk=32, kv_chunk=32,
    )
