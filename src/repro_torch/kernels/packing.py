"""Shared int4 nibble-packing layout + quantization ranges.

The layout is a cross-kernel invariant: adjacent head-dim pairs pack into
one uint8 with the EVEN index in the LOW nibble, nibbles in two's
complement (``repro.kernels.packing``). The plain versions use these
helpers; the CUDA kernels use the same layout from ``csrc/int4.cuh``.
"""

from __future__ import annotations

import torch

QMAX = {8: 127.0, 4: 7.0}


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """[..., hd] integer values in [-7, 7] -> [..., hd//2] uint8."""
    qi = q.to(torch.int32)
    lo = qi[..., 0::2] & 0xF
    hi = qi[..., 1::2] & 0xF
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_int4(payload: torch.Tensor) -> torch.Tensor:
    """[..., hd//2] uint8 -> [..., hd] f32 values in [-8, 7]."""
    p = payload.to(torch.int32)
    lo = p & 0xF
    hi = (p >> 4) & 0xF
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    q = torch.stack([lo, hi], dim=-1).reshape(*p.shape[:-1], p.shape[-1] * 2)
    return q.to(torch.float32)
