"""kimi-k2-1t-a32b [moe] — trillion-param MoE: 384 routed experts top-8 +

1 shared, 61 layers, first layer dense (arXiv:2501.kimi2 per assignment).
Expert FFN width 2048 (fine-grained); dense layer 0 uses a wide FFN."""
from ..models.moe import MoEConfig
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,  # the leading dense layer's FFN
    vocab=163840,
    rope_theta=5e6,
    moe=MoEConfig(
        n_experts=384, top_k=8, d_ff_expert=2048,
        n_shared_experts=1, d_ff_shared=2048, capacity_factor=1.25,
    ),
    moe_first_dense=1,
)

OPTIMIZER = "adafactor"  # 1T params: factored second moment is mandatory


def reduced() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=256, vocab=256,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, n_shared_experts=1,
                      d_ff_shared=32),
        moe_first_dense=1, q_chunk=32, kv_chunk=32,
    )
