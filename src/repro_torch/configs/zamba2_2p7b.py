"""zamba2-2.7b [hybrid] — Mamba2 backbone + one weight-shared attention block

applied every 6 SSD layers (arXiv:2411.15242; hf). long_500k RUNS."""
from ..models.ssm import SSMConfig
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    ssm=SSMConfig(d_model=2560, d_state=64, head_dim=64, expand=2, chunk=256),
    hybrid_attn_every=6,
)


def reduced() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=256,
        ssm=SSMConfig(d_model=64, d_state=16, head_dim=16, expand=2, chunk=32),
        hybrid_attn_every=2, q_chunk=32, kv_chunk=32,
    )
