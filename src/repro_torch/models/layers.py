"""Shared model layers: inits, norms (RMSNorm, LayerNorm), rotary
embeddings (RoPE, Qwen2-VL's M-RoPE), activations, after
``repro.models.layers``.

Parameters are plain dictionaries of tensors in the JAX package's layouts;
every layer is a function (params, x) -> y. Rounding points follow the
reference: norms and rope compute in f32 and cast back to the input dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dense_init(gen: torch.Generator, shape, in_axis: int = 0, dtype=torch.bfloat16,
               device="cpu") -> torch.Tensor:
    """Truncated-normal fan-in init (in f32, then cast)."""
    fan_in = shape[in_axis]
    std = (1.0 / fan_in) ** 0.5
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.bfloat16, device="cpu") -> torch.Tensor:
    w = torch.empty(shape, dtype=torch.float32, device=device)
    w.normal_(0.0, 1.0, generator=gen)
    return (w * 0.02).to(dtype)


def rmsnorm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w).to(dtype)


def layernorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """f32 mean and (biased) variance over the last dim, ``rsqrt(var +
    eps)``, then ``scale``/``bias``; cast back to the input dtype."""
    dtype = x.dtype
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(dtype)


def make_norm_params(kind: str, dim: int, lead=(), device="cpu"):
    """f32 norm parameters with leading dims ``lead``: a weight of ones for
    rmsnorm, ``{"scale": ones, "bias": zeros}`` for layernorm."""
    shape = tuple(lead) + (dim,)
    if kind == "rmsnorm":
        return torch.ones(shape, dtype=torch.float32, device=device)
    return {"scale": torch.ones(shape, dtype=torch.float32, device=device),
            "bias": torch.zeros(shape, dtype=torch.float32, device=device)}


def apply_norm(kind: str, params, x: torch.Tensor, eps: float) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(params, x, eps)
    return layernorm(params, x, eps)


def rope_freqs(head_dim: int, theta: float, device="cpu") -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: broadcastable to [..., seq]."""
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, x.device)  # [hd/2]
    angles = positions[..., None].to(torch.float32) * freqs  # [..., seq, hd/2]
    cos = torch.cos(angles)[..., None, :]  # [..., seq, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: the rotary dims split into (t, h, w)
    sections, each rotated by its own position axis.

    x: [batch, seq, heads, head_dim]; positions3: [3, batch, seq] (text
    tokens carry identical t/h/w ids, where M-RoPE equals 1-D RoPE)."""
    head_dim = x.shape[-1]
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {tuple(sections)} must sum to head_dim/2 = {half}")
    if positions3.dim() != 3 or positions3.shape[0] != 3:
        raise ValueError(f"mrope positions must be [3, B, S], got {tuple(positions3.shape)}")
    freqs = rope_freqs(head_dim, theta, x.device)  # [half]
    # Which section (and so which position axis) each rotary dim uses.
    sec_id = torch.repeat_interleave(torch.arange(3, device=x.device),
                                     torch.as_tensor(sections, device=x.device),
                                     output_size=half)  # [half]
    pos_per_dim = positions3.to(torch.float32)[sec_id]  # [half, B, S]
    angles = pos_per_dim.permute(1, 2, 0) * freqs  # [B, S, half]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate.to(torch.float32)).to(gate.dtype) * up


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU in f32, cast back (``jax.nn.gelu(...,
    approximate=True)``)."""
    return F.gelu(x.to(torch.float32), approximate="tanh").to(x.dtype)
