"""minicpm-2b [dense] — llama-like, trained with the WSD schedule

(arXiv:2404.06395; hf). Its config selects the WSD optimizer schedule."""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab=122753,
)

SCHEDULE = "wsd"  # warmup-stable-decay (the paper's training schedule)


def reduced() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=256, q_chunk=32, kv_chunk=32,
    )
