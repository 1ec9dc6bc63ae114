"""Cohere Command-R 35B [hf:CohereForAI/c4ai-command-r-v01] — dense decoder,
GQA kv=8, no biases, 256k vocab (the strongest cold-embedding case for
tiered optimizer state)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command_r_35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    act="swiglu",
    rope_theta=10000.0,
    tie_embeddings=True,  # command-r ties input/output embeddings
)

SMOKE = ModelConfig(
    name="command_r_35b_smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=160,
    vocab_size=256,
    act="swiglu",
    tie_embeddings=True,
)
