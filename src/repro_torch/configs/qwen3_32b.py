"""Qwen3-32B [hf:Qwen/Qwen3-8B family] — dense decoder, GQA kv=8,
per-head q/k RMS norm, head_dim=128."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3_32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_ff=25600,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    act="swiglu",
    rope_theta=1000000.0,
)

SMOKE = ModelConfig(
    name="qwen3_32b_smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=160,
    vocab_size=256,
    head_dim=32,
    qk_norm=True,
    act="swiglu",
)
