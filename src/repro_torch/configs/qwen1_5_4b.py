"""Qwen1.5-4B [hf:Qwen/Qwen1.5 family] — dense decoder, MHA (kv=20) with
QKV biases."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1_5_4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    act="swiglu",
    rope_theta=1000000.0,
)

SMOKE = ModelConfig(
    name="qwen1_5_4b_smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=160,
    vocab_size=256,
    qkv_bias=True,
    act="swiglu",
)
