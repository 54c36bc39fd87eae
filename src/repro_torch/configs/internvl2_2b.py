"""internvl2-2b [vlm] — InternViT + InternLM2 backbone (arXiv:2404.16821; hf).

Backbone only: the vision frontend is a stub; input_specs() provides
precomputed patch embeddings [B, 256, d_model] prepended to the tokens.
"""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92553,
    rope_theta=1e6,
    vision_patches=256,
)


def reduced() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=256, vision_patches=8, q_chunk=32, kv_chunk=32,
    )
