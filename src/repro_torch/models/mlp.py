"""Dense FFN block (SwiGLU), after ``repro.models.mlp``."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers


def init_mlp_params(gen: torch.Generator, cfg: ModelConfig, lead=(), d_ff=None,
                    dtype=torch.bfloat16, device="cpu") -> dict:
    """FFN weights with leading dims ``lead`` (the layer stack)."""
    if cfg.act != "swiglu":
        raise NotImplementedError(f"act {cfg.act!r} is not ported yet (swiglu only)")
    d_ff = d_ff or cfg.d_ff
    lead = tuple(lead)
    ax = len(lead)

    def init(shape):
        return layers.dense_init(gen, lead + shape, in_axis=ax, dtype=dtype, device=device)

    return {
        "w_gate": init((cfg.d_model, d_ff)),
        "w_up": init((cfg.d_model, d_ff)),
        "w_down": init((d_ff, cfg.d_model)),
    }


def mlp(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.act != "swiglu":
        raise NotImplementedError(f"act {cfg.act!r} is not ported yet (swiglu only)")
    gate = torch.matmul(x, p["w_gate"])
    up = torch.matmul(x, p["w_up"])
    return torch.matmul(layers.swiglu(gate, up), p["w_down"])
