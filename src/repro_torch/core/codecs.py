"""Block-quantization codecs, after ``repro.core.codecs``: the fixed ratios
and modeled decode costs that ``tiers.py`` and ``tco.py`` price tiers with,
and each codec's encode/decode transform on torch tensors.

    codec   ratio (w/ scales)   decode cost     paper analogue
    none    1.00x               0               uncompressed DRAM
    fp8     ~2.00x              cast            lz4      (fast, modest ratio)
    int8    ~1.94x              scale-mul       lzo      (balanced)
    int4    ~3.56x              unpack+scale    zstd-ish (dense)
    int2    ~5.33x              unpack+scale    deflate  (max ratio, slow)
    cxl_hw  ~1.88x nominal      ~0 (inline hw)  ZeroPoint CXL line compressor

``cxl_hw`` models an inline hardware compressor on a CXL expander: software
quantizes to dense int8 lines; the controller narrows lines whose codewords
fit int4 range (``cxl_line_bits``), so the stored and wire bytes depend on
the data (up to 2x the nominal ratio) while decode costs nearly nothing.
These are the software side of the ``cxl_hw`` tier; the KV-page codecs the
serving path runs are the kernels of ``repro_torch.kernels``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.core import hw

# Group sizes for per-group absmax scaling (elements sharing one f32 scale).
# ``cxl_hw`` scales are deliberately coarse (one per 512 codewords): the
# inline compressor narrows 64-codeword hardware lines whose local range is
# small relative to the shared scale.
GROUP = {"int8": 128, "int4": 64, "int2": 32, "cxl_hw": 512}
SCALE_BYTES = 4  # f32 scales

# Inline line compressor: a stored line narrows to 4-bit codewords when every
# quantized value in it fits int4 range.
CXL_LINE_ELEMS = 64  # int8 codewords per hardware cache line
CXL_LINE_NARROW_QMAX = 7  # |q| <= 7 -> the controller stores the line 4-bit


@dataclasses.dataclass(frozen=True)
class Encoded:
    """A compressed block: uint8 payload + f32 per-group scales."""

    payload: torch.Tensor  # uint8, flat
    scales: torch.Tensor  # f32, flat (empty for fp8/none)
    codec: str


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """IEEE ``x / c`` on every device (a Python-scalar divide on CUDA is a
    reciprocal multiply)."""
    return x / torch.tensor(c, dtype=torch.float32, device=x.device)


def _group_reshape(x: torch.Tensor, group: int) -> torch.Tensor:
    flat = x.reshape(-1)
    if flat.shape[0] % group:
        raise ValueError(f"block elems {flat.shape[0]} not divisible by group {group}")
    return flat.reshape(-1, group)


# ---------------------------------------------------------------------------
# int-k family: per-group absmax scale, packed little-endian into uint8.
# ---------------------------------------------------------------------------


def _int_encode(x: torch.Tensor, bits: int, group: int) -> Encoded:
    qmax = (1 << (bits - 1)) - 1 if bits > 2 else 1  # int2 uses {-1,0,1}
    g = _group_reshape(x.to(torch.float32), group)
    scale = _div(g.abs().amax(dim=1, keepdim=True), qmax)
    scale = torch.where(scale == 0.0, 1.0, scale)
    q = torch.clamp(torch.round(g / scale), -qmax, qmax).to(torch.int8)
    per_byte = 8 // bits
    qf = q.reshape(-1, per_byte)  # values packed into one byte
    packed = torch.zeros(qf.shape[0], dtype=torch.uint8, device=x.device)
    mask = (1 << bits) - 1
    for i in range(per_byte):
        nib = (qf[:, i].to(torch.int32) & mask).to(torch.uint8)
        packed = packed | (nib << (bits * i)).to(torch.uint8)
    return Encoded(payload=packed, scales=scale.reshape(-1), codec=f"int{bits}")


def _int_decode(enc: Encoded, bits: int, group: int, n_elem: int) -> torch.Tensor:
    per_byte = 8 // bits
    mask = (1 << bits) - 1
    sign_bit = 1 << (bits - 1)
    vals = []
    for i in range(per_byte):
        nib = (enc.payload.to(torch.int32) >> (bits * i)) & mask
        vals.append(torch.where(nib >= sign_bit, nib - (1 << bits), nib))
    q = torch.stack(vals, dim=1).reshape(-1)[:n_elem].to(torch.float32)
    scale = torch.repeat_interleave(enc.scales, group)[:n_elem]
    return q * scale


# ---------------------------------------------------------------------------
# fp8: one f32 normalizer per block, payload is float8_e4m3fn bytes.
# ---------------------------------------------------------------------------

_FP8_MAX = 448.0  # e4m3fn max finite


def _fp8_encode(x: torch.Tensor) -> Encoded:
    flat = x.to(torch.float32).reshape(-1)
    norm = _div(flat.abs().amax(), _FP8_MAX)
    norm = torch.where(norm == 0.0, 1.0, torch.clamp(norm, min=1e-30))
    f8 = (flat / norm).to(torch.float8_e4m3fn)
    return Encoded(payload=f8.view(torch.uint8), scales=norm.reshape(1), codec="fp8")


def _fp8_decode(enc: Encoded, n_elem: int) -> torch.Tensor:
    f8 = enc.payload.view(torch.float8_e4m3fn)
    return f8.to(torch.float32)[:n_elem] * enc.scales[0]


@dataclasses.dataclass(frozen=True)
class Codec:
    """A compression algorithm: fixed ratio, fixed decode cost/elem."""

    name: str
    bits_per_elem: float  # payload bits per source element (excl. scales)
    group: int  # elements per f32 scale (0 = one scale per block)

    def payload_bytes(self, n_elem: int) -> int:
        return int(n_elem * self.bits_per_elem) // 8

    def scale_bytes(self, n_elem: int) -> int:
        if self.name == "none":
            return 0
        n_groups = 1 if self.group == 0 else (n_elem + self.group - 1) // self.group
        return n_groups * SCALE_BYTES

    def compressed_bytes(self, n_elem: int) -> int:
        return self.payload_bytes(n_elem) + self.scale_bytes(n_elem)

    def ratio(self, n_elem: int, src_bytes_per_elem: int = 2) -> float:
        if self.name == "none":
            return 1.0
        return (n_elem * src_bytes_per_elem) / self.compressed_bytes(n_elem)

    # -- transform ----------------------------------------------------------
    def encode(self, x: torch.Tensor) -> Encoded:
        if self.name == "none":
            flat = x.to(torch.bfloat16).reshape(-1).contiguous()
            return Encoded(payload=flat.view(torch.uint8),
                           scales=torch.zeros((0,), dtype=torch.float32, device=x.device),
                           codec="none")
        if self.name == "fp8":
            return _fp8_encode(x)
        if self.name == "cxl_hw":
            # Software side of the hardware tier: per-group int8 quantization.
            # Line narrowing happens in the controller model, not in this
            # dense payload (see ``cxl_line_ratio``).
            enc = _int_encode(x, 8, self.group)
            return Encoded(payload=enc.payload, scales=enc.scales, codec=self.name)
        return _int_encode(x, int(self.name[3:]), self.group)

    def decode(self, enc: Encoded, shape, dtype=torch.bfloat16) -> torch.Tensor:
        n_elem = 1
        for s in shape:
            n_elem *= int(s)
        if self.name == "none":
            flat = enc.payload.reshape(-1).contiguous().view(torch.bfloat16)
            return flat[:n_elem].reshape(shape).to(dtype)
        if self.name == "fp8":
            return _fp8_decode(enc, n_elem).reshape(shape).to(dtype)
        bits = 8 if self.name == "cxl_hw" else int(self.name[3:])
        return _int_decode(enc, bits, self.group, n_elem).reshape(shape).to(dtype)

    # -- modeled costs ------------------------------------------------------
    @property
    def decode_ops_per_elem(self) -> float:
        return hw.CODEC_DECODE_OPS[self.name]

    @property
    def encode_ops_per_elem(self) -> float:
        return hw.CODEC_ENCODE_OPS[self.name]


CODECS: Dict[str, Codec] = {
    "none": Codec("none", 16.0, 0),
    "fp8": Codec("fp8", 8.0, 0),
    "int8": Codec("int8", 8.0, GROUP["int8"]),
    "int4": Codec("int4", 4.0, GROUP["int4"]),
    "int2": Codec("int2", 2.0, GROUP["int2"]),
    "cxl_hw": Codec("cxl_hw", 8.0, GROUP["cxl_hw"]),
}


def cxl_line_bits(payload, line_elems: int = CXL_LINE_ELEMS) -> torch.Tensor:
    """Per-hardware-line stored width (4 or 8 bits/codeword) the inline
    compressor achieves on a ``cxl_hw`` payload (a tensor or array of
    bytes). Lines whose every two's-complement codeword fits
    ``[-CXL_LINE_NARROW_QMAX, CXL_LINE_NARROW_QMAX]`` narrow to 4-bit
    storage; the rest stay 8-bit."""
    q = torch.as_tensor(payload).reshape(-1).view(torch.int8)
    lines = q.reshape(-1, line_elems).to(torch.int32)
    narrow = lines.abs().amax(dim=1) <= CXL_LINE_NARROW_QMAX
    return torch.where(narrow, 4, 8).to(torch.int32)


def cxl_wire_bytes(payload, scales, line_elems: int = CXL_LINE_ELEMS) -> int:
    """Bytes a ``cxl_hw`` payload actually occupies on the compressed media
    (narrowed line payloads + uncompressed scales)."""
    bits = cxl_line_bits(payload, line_elems).to(torch.int64)
    return int((bits * line_elems).sum()) // 8 + int(torch.as_tensor(scales).numel()) * SCALE_BYTES


def cxl_line_ratio(payload, line_elems: int = CXL_LINE_ELEMS) -> float:
    """Observed line-compression ratio: nominal dense payload bytes over the
    bytes the controller stores/moves. In [1, 2]: 1.0 when no line narrows,
    2.0 when every line holds int4-range values."""
    bits = cxl_line_bits(payload, line_elems).to(torch.int64)
    nominal = int(torch.as_tensor(payload).numel()) * 8
    wire = int(bits.sum()) * line_elems
    return float(nominal) / float(max(wire, 1))


def roundtrip_error(codec_name: str, x: torch.Tensor) -> torch.Tensor:
    """Relative L2 reconstruction error of one encode/decode roundtrip."""
    codec = CODECS[codec_name]
    xh = codec.decode(codec.encode(x), x.shape, torch.float32)
    num = torch.linalg.vector_norm(x.to(torch.float32) - xh)
    den = torch.clamp(torch.linalg.vector_norm(x.to(torch.float32)), min=1e-12)
    return num / den
