"""Shared model layers: inits, norms, rotary embeddings, activations, after
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


def make_norm_params(kind: str, dim: int, device="cpu"):
    if kind != "rmsnorm":
        raise NotImplementedError(f"norm {kind!r} is not ported yet (rmsnorm only)")
    return torch.ones((dim,), dtype=torch.float32, device=device)


def apply_norm(kind: str, params, x: torch.Tensor, eps: float) -> torch.Tensor:
    if kind != "rmsnorm":
        raise NotImplementedError(f"norm {kind!r} is not ported yet (rmsnorm only)")
    return rmsnorm(params, x, eps)


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


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate.to(torch.float32)).to(gate.dtype) * up


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU in f32, cast back (``jax.nn.gelu(...,
    approximate=True)``)."""
    return F.gelu(x.to(torch.float32), approximate="tanh").to(x.dtype)
