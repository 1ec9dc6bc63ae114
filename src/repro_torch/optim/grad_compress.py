"""Int8 error-feedback gradient compression for the cross-pod reduce, after
``repro.optim.grad_compress``.

The wire format: per-group absmax int8 (group 256, 4x fewer bytes than
f32), with an error-feedback residual so that compression noise becomes a
delayed, not a lost, contribution (EF-SGD). On one device the reduce over
the pod axis has one participant: ``compressed_psum_tree`` keeps the
reference's ``axis_name`` argument, and its sum is the identity.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.nn.functional as F

from repro_torch import pytree

PyTree = Any

GROUP = 256
QMAX = 127.0


def _enc(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    flat = x.to(torch.float32).reshape(-1)
    pad = (-flat.shape[0]) % GROUP
    if pad:
        flat = F.pad(flat, (0, pad))
    g = flat.reshape(-1, GROUP)
    amax = torch.amax(torch.abs(g), dim=1, keepdim=True)
    # A divisor on the tensor's device: CUDA multiplies by the reciprocal of
    # a Python scalar divisor, which rounds apart from a division.
    scale = torch.clamp(amax / amax.new_full((), QMAX), min=1e-20)
    q = torch.clamp(torch.round(g / scale), -QMAX, QMAX).to(torch.int8)
    return q, scale


def _dec(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= int(s)
    x = q.to(torch.float32) * scale
    return x.reshape(-1)[:n].reshape(shape)


def compress_roundtrip(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (quantized_value, residual): x = value + residual."""
    q, s = _enc(x)
    xq = _dec(q, s, x.shape)
    return xq, x.to(torch.float32) - xq


def compressed_psum_tree(grads: PyTree, residual: PyTree, axis_name: str
                         ) -> Tuple[PyTree, PyTree]:
    """Error-feedback compressed all-reduce over ``axis_name``: each
    participant quantizes (grad + residual) to int8, the quantized values
    are summed, and the quantization error is next step's residual. On one
    device the axis has one participant, so the sum is the quantized value
    itself. Returns (summed, new residual), f32."""
    flat_g = pytree.leaves(grads)
    flat_r = pytree.leaves(residual) if residual is not None else [None] * len(flat_g)
    out = [compress_roundtrip(g.to(torch.float32) + (0.0 if r is None else r))
           for g, r in zip(flat_g, flat_r)]
    return (pytree.unflatten(grads, [o[0] for o in out]),
            pytree.unflatten(grads, [o[1] for o in out]))


def init_residual(params: PyTree) -> PyTree:
    return pytree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def wire_bytes(params: PyTree) -> Tuple[int, int]:
    """(uncompressed f32 bytes, compressed int8+scales bytes) per reduce."""
    leaves = pytree.leaves(params)
    raw = sum(p.numel() * 4 for p in leaves)
    comp = sum(p.numel() + (p.numel() // GROUP + 1) * 4 for p in leaves)
    return raw, comp
