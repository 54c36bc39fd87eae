"""whisper-large-v3 [audio] — enc-dec (arXiv:2212.04356). Conv frontend is a

STUB: input_specs() provides precomputed frame embeddings [B, 1500, d]."""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,  # decoder layers
    encoder_layers=32,
    encoder_frames=1500,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
)


def reduced() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=2, encoder_layers=2, encoder_frames=16, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=256, q_chunk=32, kv_chunk=32,
    )
