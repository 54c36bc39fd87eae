"""mamba2-130m [ssm] — attention-free SSD (arXiv:2405.21060).

d_inner = 2*768 = 1536, head_dim 64 -> 24 SSD heads, d_state 128.
long_500k RUNS (O(1) state per token)."""
from ..models.ssm import SSMConfig
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=1,  # unused for ssm family (SSD heads live in SSMConfig)
    n_kv_heads=1,
    d_ff=0,
    vocab=50280,
    ssm=SSMConfig(d_model=768, d_state=128, head_dim=64, expand=2, chunk=256),
)


def reduced() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, vocab=256,
        ssm=SSMConfig(d_model=64, d_state=16, head_dim=16, expand=2, chunk=32),
    )
