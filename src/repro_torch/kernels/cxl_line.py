"""Page codec of the cxl_hw expander tier: wrappers of the two CUDA kernels
in ``csrc/cxl_line.cu``.

``cxl_encode_pages`` replaces the Pallas kernel
``repro/kernels/cxl_line.py::cxl_encode_pages``: the int8 quantization of
``quant_pages(., 8)`` plus the stored width of each 64-codeword hardware
line, 4 or 8 bits. Its kernel is ``csrc/row_group.cuh``'s requantization
step, the one ``quant_pages`` runs, with line widths added (a segmented
shuffle over the lanes that hold a line, ``row_group.line_geometry``), so
payload and scales equal ``quant_pages(., 8)``'s by construction; pointers
off its 16-byte vectors raise. ``cxl_decode_pages`` replaces
``repro/kernels/cxl_line.py::cxl_decode_pages``: int8 times the row scale,
in f32 (the controller decompresses inline). Its kernel is the row-group
dequant step at int8 -> f32, the one ``dequant_pages`` runs
(``row_group.dequant_geometry``: every even head_dim <= 256; pointers off
its vectors raise). The cache reads HOST8 pages that live on the ``cxl_hw``
expander through it. Both are bound by bytes. Off the card (``build.on_card``) the plain
versions (``ref.cxl_encode_kv_page`` / ``ref.cxl_decode_kv_page``) run.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.row_group import dequant_geometry, line_geometry

_P = ctypes.c_void_p


def cxl_encode_pages(pages: torch.Tensor):
    """pages [P, T, KV, hd] bf16/f32 (hd a multiple of 64) -> (payload int8
    [P, T, KV, hd], scales f32 [P, T, KV], line_bits int32
    [P, T, KV, hd // 64])."""
    if not build.on_card(pages):
        return ref.cxl_encode_kv_page(pages)
    name = "cxl_encode_pages"
    p, t, kv, hd = pages.shape
    dev = pages.device
    build.check_operand(name, "pages", pages, (torch.float32, torch.bfloat16), dev)
    geo = line_geometry(hd, "bf16" if pages.dtype == torch.bfloat16 else "f32", name).row
    build.check_aligned(name, "pages", pages, geo.vec_bytes)
    payload = torch.empty((p, t, kv, hd), dtype=torch.int8, device=dev)
    scales = torch.empty((p, t, kv), dtype=torch.float32, device=dev)
    line_bits = torch.empty((p, t, kv, hd // ref.CXL_LINE_ELEMS), dtype=torch.int32, device=dev)
    build.check_aligned(name, "payload", payload, geo.out_align)
    fn = build.load("cxl_line").cxl_encode_pages_launch
    fn.argtypes = [_P, ctypes.c_int, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, _P]
    fn.restype = ctypes.c_int
    err = fn(pages.data_ptr(), int(pages.dtype == torch.bfloat16), payload.data_ptr(),
             scales.data_ptr(), line_bits.data_ptr(), p * t * kv, hd, geo.vec_bytes, geo.lanes,
             geo.vectors, build.stream_handle(dev))
    build.check(err, name)
    build.count_launch(name)
    return payload, scales, line_bits


def cxl_decode_pages(payload: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(payload int8 [P, T, KV, hd], scales f32 [P, T, KV]) -> pages f32
    [P, T, KV, hd]."""
    if not build.on_card(payload):
        return ref.cxl_decode_kv_page(payload, scales)
    name = "cxl_decode_pages"
    p, t, kv, hd = payload.shape
    geo = dequant_geometry(hd, "int8", "f32", name)
    dev = payload.device
    build.check_operand(name, "payload", payload, torch.int8, dev)
    build.check_operand(name, "scales", scales, torch.float32, dev, (p, t, kv))
    build.check_aligned(name, "payload", payload, geo.vec_bytes)
    out = torch.empty((p, t, kv, hd), dtype=torch.float32, device=dev)
    build.check_aligned(name, "out", out, geo.out_align)
    fn = build.load("cxl_line").cxl_decode_pages_launch
    fn.argtypes = [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, _P]
    fn.restype = ctypes.c_int
    err = fn(payload.data_ptr(), scales.data_ptr(), out.data_ptr(), p * t * kv, hd,
             geo.vec_bytes, geo.lanes, geo.vectors, build.stream_handle(dev))
    build.check(err, name)
    build.count_launch(name)
    return out
