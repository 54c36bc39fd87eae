"""deepseek-moe-16b [moe] — fine-grained experts: 2 shared + 64 routed top-6,

first layer dense (arXiv:2401.06066; hf)."""
from ..models.moe import MoEConfig
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,  # the leading dense layer's FFN
    vocab=102400,
    moe=MoEConfig(
        n_experts=64, top_k=6, d_ff_expert=1408,
        n_shared_experts=2, d_ff_shared=2816, capacity_factor=1.25,
    ),
    moe_first_dense=1,
)


def reduced() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab=256,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, n_shared_experts=2,
                      d_ff_shared=64),
        moe_first_dense=1, q_chunk=32, kv_chunk=32,
    )
