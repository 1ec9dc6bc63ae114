"""KV-page dequantization (the tier decompress path): wrapper of the CUDA
kernel ``csrc/dequant_page.cu``, and its plain version.

Replaces the Pallas kernel ``repro/kernels/dequant_page.py::dequant_pages``.
The cache runs it for the host sentinels' key centroids (f32 out) and the
per-page path's page fetch (``_fetch_dense``). Bound by bytes, mostly the
stores: each payload byte and scale is read once and each output element
written once. The kernel is ``csrc/row_group.cuh``'s dequant step: a group
of lanes covers a row, each lane loading the codes of 16 output bytes
(``row_group.dequant_geometry``; narrower where the row is not a multiple
of them, for every even head_dim <= 256) so a warp's stores are
contiguous, keeps the next rows in flight,
turns codes into exact floats without a conversion instruction and
multiplies each by its row's scale once (IEEE), so the output equals the
plain version bit for bit in f32 and in bf16. Pointers off the geometry's
vectors raise. Off the card (``build.on_card``) the plain version runs.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.row_group import dequant_geometry

_P = ctypes.c_void_p
OUT_DTYPES = (torch.float32, torch.bfloat16)


def dequant_pages_plain(payload: torch.Tensor, scales: torch.Tensor, bits: int,
                        out_dtype=torch.bfloat16) -> torch.Tensor:
    """``ref.dequant_kv_page`` cast to ``out_dtype`` (the kernel's function)."""
    return ref.dequant_kv_page(payload, scales, bits).to(out_dtype)


def dequant_pages(payload: torch.Tensor, scales: torch.Tensor, bits: int,
                  out_dtype=torch.bfloat16) -> torch.Tensor:
    """payload [P, T, KV, hd(|//2)], scales [P, T, KV] -> pages
    [P, T, KV, hd] in ``out_dtype`` (bf16 or f32)."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"out_dtype must be one of {OUT_DTYPES}, got {out_dtype}")
    if not build.on_card(payload):
        return dequant_pages_plain(payload, scales, bits, out_dtype)
    name = "dequant_pages"
    p, t, kv, hdp = payload.shape
    hd = hdp if bits == 8 else hdp * 2
    geo = dequant_geometry(hd, f"int{bits}", "bf16" if out_dtype == torch.bfloat16 else "f32",
                           name)
    dev = payload.device
    build.check_operand(name, "payload", payload, torch.int8 if bits == 8 else torch.uint8, dev)
    build.check_operand(name, "scales", scales, torch.float32, dev, (p, t, kv))
    build.check_aligned(name, "payload", payload, geo.vec_bytes)
    out = torch.empty((p, t, kv, hd), dtype=out_dtype, device=dev)
    build.check_aligned(name, "out", out, geo.out_align)
    lib = build.load("dequant_page")
    fn = lib.dequant_pages_launch
    fn.argtypes = [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, _P]
    fn.restype = ctypes.c_int
    err = fn(payload.data_ptr(), scales.data_ptr(), out.data_ptr(), p * t * kv, hd, bits,
             int(out_dtype == torch.bfloat16), geo.vec_bytes, geo.lanes, geo.vectors,
             build.stream_handle(dev))
    build.check(err, name)
    build.count_launch(name)
    return out
