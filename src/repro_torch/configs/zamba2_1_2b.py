"""Zamba2-1.2B [arXiv:2411.15242] — hybrid: Mamba2 backbone + one
weight-shared attention+MLP block applied every 6 layers.

The shared attention keeps a full KV cache per application, so the tiered
compressed KV serves its 7 applications.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2_1_2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, conv_kernel=4, chunk=128),
    hybrid_attn_every=6,
    act="gelu",  # zamba2 shared MLP uses gelu
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="zamba2_1_2b_smoke",
    family="hybrid",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, conv_kernel=4, chunk=32),
    hybrid_attn_every=2,
    act="gelu",
    tie_embeddings=True,
)
