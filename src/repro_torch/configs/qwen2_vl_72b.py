"""Qwen2-VL 72B [arXiv:2409.12191] — VLM decoder backbone with M-RoPE
(3-axis rotary over temporal/height/width position ids).

Backbone only; the vision tower is a stub — `input_specs` supplies
precomputed patch embeddings + an embeds mask + 3-axis position ids.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2_vl_72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    mrope=True,
    mrope_sections=(16, 24, 24),
    act="swiglu",
    rope_theta=1000000.0,
    frontend="vision",
)

SMOKE = ModelConfig(
    name="qwen2_vl_72b_smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=160,
    vocab_size=256,
    head_dim=32,
    qkv_bias=True,
    mrope=True,
    mrope_sections=(4, 6, 6),
    act="swiglu",
    frontend="vision",
)
