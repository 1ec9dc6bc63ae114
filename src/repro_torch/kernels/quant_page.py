"""KV-page block quantization (the tier compress path): wrapper of the CUDA
kernel ``csrc/quant_page.cu``.

Replaces the Pallas kernel ``repro/kernels/quant_page.py::quant_pages``.
Bound by bytes: every page element is read once and its int8/int4 code and
per-(token, kv-head) scale written once. The kernel gives each row of
``head_dim`` values one warp, keeps the row in registers between the absmax
and the quantization, and loads element pairs coalesced, so each byte moves
once. On a CPU tensor the plain version (``ref.quant_kv_page``) runs.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_P = ctypes.c_void_p


def quant_pages(pages: torch.Tensor, bits: int):
    """pages [P, T, KV, hd] f32/bf16 -> (payload int8 [P, T, KV, hd] or
    uint8 [P, T, KV, hd//2], scales f32 [P, T, KV])."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    if pages.device.type == "cpu":
        return ref.quant_kv_page(pages, bits)
    name = "quant_pages"
    p, t, kv, hd = pages.shape
    if hd % 2 or hd > 256:
        raise ValueError(f"{name}: head_dim {hd} must be even and <= 256")
    dev = pages.device
    build.check_operand(name, "pages", pages, (torch.float32, torch.bfloat16), dev)
    hd_out = hd if bits == 8 else hd // 2
    payload = torch.empty((p, t, kv, hd_out), dtype=torch.int8 if bits == 8 else torch.uint8,
                          device=dev)
    scales = torch.empty((p, t, kv), dtype=torch.float32, device=dev)
    lib = build.load("quant_page")
    fn = lib.quant_pages_launch
    fn.argtypes = [_P, ctypes.c_int, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P]
    fn.restype = ctypes.c_int
    err = fn(pages.data_ptr(), int(pages.dtype == torch.bfloat16), payload.data_ptr(),
             scales.data_ptr(), p * t * kv, hd, bits, build.stream_handle(dev))
    build.check(err, name)
    build.count_launch(name)
    return payload, scales
