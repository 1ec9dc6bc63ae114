"""Fused KV-page transcode (tier-to-tier requantization, int8 <-> int4):
wrapper of the CUDA kernel ``csrc/transcode_page.cu``.

Replaces the Pallas kernel ``repro/kernels/transcode_page.py::transcode_pages``
on the migration path. Bound by bytes: each page's payload and scales are
read once and its requantized payload and scales written once. The kernel
dequantizes, takes the new absmax scale and requantizes a row in registers
(one warp per row), so the dense page never reaches device memory; its
payload is byte-equal to ``ref.transcode_kv_page``. On a CPU tensor the plain
version runs.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_P = ctypes.c_void_p


def transcode_pages(payload: torch.Tensor, scales: torch.Tensor, src_bits: int, dst_bits: int):
    """payload [P, T, KV, hd(|//2)], scales [P, T, KV] -> (payload',
    scales') at ``dst_bits``. Same-width transcode returns its inputs."""
    if src_bits not in (8, 4) or dst_bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {src_bits} -> {dst_bits}")
    if src_bits == dst_bits:
        return payload, scales
    if payload.device.type == "cpu":
        return ref.transcode_kv_page(payload, scales, src_bits, dst_bits)
    name = "transcode_pages"
    p, t, kv, hdp = payload.shape
    hd = hdp if src_bits == 8 else hdp * 2
    if hd % 2 or hd > 256:
        raise ValueError(f"{name}: head_dim {hd} must be even and <= 256")
    dev = payload.device
    build.check_operand(name, "payload", payload,
                        torch.int8 if src_bits == 8 else torch.uint8, dev)
    build.check_operand(name, "scales", scales, torch.float32, dev, (p, t, kv))
    hd_out = hd if dst_bits == 8 else hd // 2
    out = torch.empty((p, t, kv, hd_out), dtype=torch.int8 if dst_bits == 8 else torch.uint8,
                      device=dev)
    new_scales = torch.empty((p, t, kv), dtype=torch.float32, device=dev)
    lib = build.load("transcode_page")
    fn = lib.transcode_pages_launch
    fn.argtypes = [_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, _P]
    fn.restype = ctypes.c_int
    err = fn(payload.data_ptr(), scales.data_ptr(), out.data_ptr(), new_scales.data_ptr(),
             p * t * kv, hd, src_bits, dst_bits, build.stream_handle(dev))
    build.check(err, name)
    build.count_launch(name)
    return out, new_scales
