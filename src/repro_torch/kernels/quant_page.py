"""KV-page block quantization (the tier compress path): wrapper of the CUDA
kernel ``csrc/quant_page.cu``.

Replaces the Pallas kernel ``repro/kernels/quant_page.py::quant_pages``.
Bound by bytes: every page element is read once and its int8/int4 code and
per-(token, kv-head) scale written once. The kernel (``csrc/row_group.cuh``)
gives each row of ``head_dim`` values a group of lanes that load it in
16-byte vectors (``row_group.row_geometry``), keeps the next rows' loads in
flight while it quantizes the current ones, and multiplies by the row's
reciprocal scale except within 2^-15 of a rounding tie, where it divides:
the codes are byte-equal to the plain version's. Pages may be f32 or bf16
(the KV cache's own type: the kernel's upcast is exact). Off the card
(``build.on_card``) the plain version (``ref.quant_kv_page``) runs.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.row_group import row_geometry

_P = ctypes.c_void_p


def quant_pages(pages: torch.Tensor, bits: int):
    """pages [P, T, KV, hd] f32/bf16 -> (payload int8 [P, T, KV, hd] or
    uint8 [P, T, KV, hd//2], scales f32 [P, T, KV])."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    if not build.on_card(pages):
        return ref.quant_kv_page(pages, bits)
    name = "quant_pages"
    p, t, kv, hd = pages.shape
    geo = row_geometry(hd, "bf16" if pages.dtype == torch.bfloat16 else "f32", bits, name)
    dev = pages.device
    build.check_operand(name, "pages", pages, (torch.float32, torch.bfloat16), dev)
    build.check_aligned(name, "pages", pages, geo.vec_bytes)
    hd_out = hd if bits == 8 else hd // 2
    payload = torch.empty((p, t, kv, hd_out), dtype=torch.int8 if bits == 8 else torch.uint8,
                          device=dev)
    scales = torch.empty((p, t, kv), dtype=torch.float32, device=dev)
    build.check_aligned(name, "payload", payload, geo.out_align)
    lib = build.load("quant_page")
    fn = lib.quant_pages_launch
    fn.argtypes = [_P, ctypes.c_int, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, _P]
    fn.restype = ctypes.c_int
    err = fn(pages.data_ptr(), int(pages.dtype == torch.bfloat16), payload.data_ptr(),
             scales.data_ptr(), p * t * kv, hd, bits, geo.vec_bytes, geo.lanes, geo.vectors,
             build.stream_handle(dev))
    build.check(err, name)
    build.count_launch(name)
    return payload, scales


def empty_launch(device) -> None:
    """Measurement hook: launch an empty one-block kernel through the same
    ctypes path as the kernels, the floor under every small launch, which
    ``chip_smoke.py`` and ``scripts/row_group_times.py`` time. No path of
    the port calls it, and it counts no launch. Keep it the only such hook
    in the kernel libraries."""
    fn = build.load("quant_page").empty_launch
    fn.argtypes = [_P]
    fn.restype = ctypes.c_int
    build.check(fn(build.stream_handle(torch.device(device))), "empty_launch")
