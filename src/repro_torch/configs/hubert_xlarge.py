"""HuBERT X-Large [arXiv:2106.07447] — audio encoder-only transformer.

Backbone only; the conv waveform frontend is a stub (`input_specs` provides
precomputed frame embeddings). vocab=504 is the masked-prediction codebook.
Encoder-only => no decode shapes (recorded skip).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert_xlarge",
    family="encoder",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    act="gelu",
    norm="layernorm",
    causal=False,
    frontend="audio",
    rope_theta=10000.0,  # conv-positional in the original; RoPE stands in
)

SMOKE = ModelConfig(
    name="hubert_xlarge_smoke",
    family="encoder",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=64,
    act="gelu",
    norm="layernorm",
    causal=False,
    frontend="audio",
)
