"""Qwen3-MoE 235B-A22B [hf:Qwen/Qwen3-30B-A3B family] — MoE decoder:
94 layers, 128 experts top-8, per-expert d_ff=1536, GQA kv=4, qk-norm."""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3_moe_235b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,  # per-expert (mirrored in moe.d_ff_expert)
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    act="swiglu",
    rope_theta=1000000.0,
    moe=MoEConfig(n_experts=128, experts_per_token=8, d_ff_expert=1536),
)

SMOKE = ModelConfig(
    name="qwen3_moe_235b_smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=96,
    vocab_size=256,
    head_dim=32,
    qk_norm=True,
    act="swiglu",
    moe=MoEConfig(n_experts=8, experts_per_token=2, d_ff_expert=96),
)
