"""DBRX 132B [hf:databricks/dbrx-base] — fine-grained MoE decoder:
16 experts top-4, per-expert d_ff=10752, GQA kv=8."""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx_132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    act="swiglu",
    rope_theta=500000.0,
    moe=MoEConfig(n_experts=16, experts_per_token=4, d_ff_expert=10752),
)

SMOKE = ModelConfig(
    name="dbrx_132b_smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    act="swiglu",
    moe=MoEConfig(n_experts=4, experts_per_token=2, d_ff_expert=128),
)
