"""Dense FFN blocks (SwiGLU / GELU), after ``repro.models.mlp``."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers


def init_mlp_params(gen: torch.Generator, cfg: ModelConfig, lead=(), d_ff=None,
                    dtype=torch.bfloat16, device="cpu") -> dict:
    """FFN weights with leading dims ``lead`` (the layer stack): gated
    SwiGLU, or GELU with biases."""
    d_ff = d_ff or cfg.d_ff
    lead = tuple(lead)
    ax = len(lead)

    def init(shape):
        return layers.dense_init(gen, lead + shape, in_axis=ax, dtype=dtype, device=device)

    if cfg.act == "swiglu":
        return {
            "w_gate": init((cfg.d_model, d_ff)),
            "w_up": init((cfg.d_model, d_ff)),
            "w_down": init((d_ff, cfg.d_model)),
        }
    return {
        "w_up": init((cfg.d_model, d_ff)),
        "b_up": torch.zeros(lead + (d_ff,), dtype=dtype, device=device),
        "w_down": init((d_ff, cfg.d_model)),
        "b_down": torch.zeros(lead + (cfg.d_model,), dtype=dtype, device=device),
    }


def mlp(p: dict, cfg: ModelConfig, x: torch.Tensor, swiglu=layers.swiglu) -> torch.Tensor:
    """The dense FFN; ``swiglu`` computes SiLU(gate) * up (the tiered decode
    step passes its kernel)."""
    if cfg.act == "swiglu":
        gate = torch.matmul(x, p["w_gate"])
        up = torch.matmul(x, p["w_up"])
        return torch.matmul(swiglu(gate, up), p["w_down"])
    h = torch.matmul(x, p["w_up"]) + p["b_up"]
    return torch.matmul(layers.gelu(h), p["w_down"]) + p["b_down"]
