"""InternLM2-20B [arXiv:2403.17297] — dense decoder, GQA kv=8."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2_20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92544,
    act="swiglu",
    rope_theta=1000000.0,
)

SMOKE = ModelConfig(
    name="internlm2_20b_smoke",
    family="dense",
    n_layers=2,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    d_ff=192,
    vocab_size=256,
    act="swiglu",
)
