"""qwen1.5-110b [dense] — GQA kv=8 with QKV bias (hf:Qwen/Qwen1.5-*)."""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab=152064,
    rope_theta=1e6,
    qkv_bias=True,
)


def reduced() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=256, q_chunk=32, kv_chunk=32,
    )
