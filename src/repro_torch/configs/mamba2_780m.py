"""Mamba2-780M [arXiv:2405.21060] — attention-free SSD decoder.

O(1) decode state: nothing grows with context, so the paper's KV tiering
does not apply to it, and the tiered serving engine refuses it (as the
reference's does). The model itself runs forward, prefill and decode.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2_780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_kernel=4, chunk=128),
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2_780m_smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=256,
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, conv_kernel=4, chunk=32),
    tie_embeddings=True,
)
