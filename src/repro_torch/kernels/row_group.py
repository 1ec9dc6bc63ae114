"""Geometry of the row-group kernels (``csrc/row_group.cuh``): the
requantization step run by ``quant_pages``, ``transcode_pages`` and
``cxl_encode_pages``, and the dequantization step run by ``dequant_pages``
and ``cxl_decode_pages``.

A row is one (page, token, kv-head) vector of ``head_dim`` values. Its bytes
are cut into ``chunks`` vectors of ``vec_bytes`` each: 16 where the row
allows it, else the widest of 8, 4, 2 or 1 bytes that divides the row and
holds whole element pairs (int4 packs pairs). A row group of ``lanes``
threads (the chunk count rounded up to a power of two, at most 32) holds the
row, each lane ``vectors`` chunks of it; a lane keeps up to
``rows_per_batch`` rows in registers (the launcher takes fewer where that
cuts the rows a lane handles in series by a tenth). The geometry depends on
(head_dim, source format, output format) only, so the wrapper can check a
pointer against it and raise; pure Python, so the CPU tests reach it.

The cxl encode adds the stored width of each 64-code hardware line
(``line_geometry``): a line covers ``64 * src_bytes / 16`` consecutive
chunks, 8 lanes at bf16 and 16 at f32, so with lane ``j`` holding chunk
``v * lanes + j`` the line of (vector v, lane j) is ``(v * lanes + j) //
lanes_per_line``, and a line's max |code| is a max over an aligned segment
of ``lanes_per_line`` lanes.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.codecs import CXL_LINE_ELEMS as LINE_CODES  # codes of a cxl_hw line

# Bits of one element of each source format.
SRC_BITS = {"f32": 32, "bf16": 16, "int8": 8, "int4": 4}
OUT_BITS = {"f32": 32, "bf16": 16}
MAX_HEAD_DIM = 256
WARP = 32
VEC_BYTES = 16


@dataclass(frozen=True)
class RowGeometry:
    vec_bytes: int  # bytes a lane loads per vector
    lanes: int  # G: lanes of a row group (power of two <= 32)
    vectors: int  # V: vectors of a row per lane (1, 2 or 4)
    rows_per_batch: int  # K: rows a lane holds at most (4 / V)
    chunks: int  # vectors per row
    out_bytes: int  # bytes a lane stores per vector (codes, or dequantized values)

    @property
    def out_align(self) -> int:
        """Alignment the output pointer needs (stores of at most 16 bytes)."""
        return min(self.out_bytes, VEC_BYTES)


def _geometry(head_dim: int, src: str, out_bits: int, kernel: str, max_vec: int = VEC_BYTES
              ) -> RowGeometry:
    if head_dim < 2 or head_dim % 2 or head_dim > MAX_HEAD_DIM:
        raise ValueError(f"{kernel}: head_dim {head_dim} must be even and in "
                         f"[2, {MAX_HEAD_DIM}]")
    pair_bytes = 2 * SRC_BITS[src] // 8
    row_bytes = head_dim * SRC_BITS[src] // 8
    vec = max_vec
    while vec > pair_bytes and row_bytes % vec:
        vec //= 2
    chunks = row_bytes // vec
    lanes = 1
    while lanes < min(chunks, WARP):
        lanes *= 2
    vectors = 1
    while lanes * vectors < chunks:
        vectors *= 2
    elems = vec * 8 // SRC_BITS[src]
    return RowGeometry(vec_bytes=vec, lanes=lanes, vectors=vectors,
                       rows_per_batch=4 // vectors, chunks=chunks,
                       out_bytes=elems * out_bits // 8)


def row_geometry(head_dim: int, src: str, dst_bits: int, kernel: str = "row_geometry"
                 ) -> RowGeometry:
    """The requantization kernels' instantiation for rows of ``head_dim``
    values in format ``src`` ("f32", "bf16", "int8" or "int4") requantized
    to ``dst_bits``; raises ValueError (naming ``kernel``) for a shape the
    kernels refuse."""
    if src not in SRC_BITS:
        raise ValueError(f"{kernel}: unknown source format {src!r}")
    if dst_bits not in (8, 4):
        raise ValueError(f"{kernel}: dst_bits must be 8 or 4, got {dst_bits}")
    return _geometry(head_dim, src, dst_bits, kernel)


# The dequant step's vectors are cut by what they become: a source vector
# is the codes of 16 output bytes (2 B of int4 or 4 B of int8 for f32, 4 B
# or 8 B for bf16), so the lanes of a group store neighbouring 16-byte
# vectors and a warp's store covers 512 contiguous bytes. Cut by the source
# instead (16 B of int4 -> 128 B of f32 a lane), each store instruction hit
# 32 separate 128-byte lines, and the kernel ran 0.0126 ms where the
# one-thread-a-pair kernel before it ran 0.0081 on an H100 (PERF.md).
DEQUANT_OUT_BYTES = 16


def dequant_geometry(head_dim: int, src: str, out: str, kernel: str = "dequant_geometry"
                     ) -> RowGeometry:
    """The dequantization kernel's instantiation for rows of ``head_dim``
    ``src`` codes ("int8" or "int4") written as ``out`` ("f32" or "bf16"):
    source vectors of the codes of 16 output bytes where the row allows it,
    else the widest that holds whole pairs; ``out_bytes`` the values one
    vector becomes."""
    if src not in ("int8", "int4") or out not in OUT_BITS:
        raise ValueError(f"{kernel}: no dequant from {src!r} to {out!r}")
    cap = DEQUANT_OUT_BYTES * SRC_BITS[src] // OUT_BITS[out]
    return _geometry(head_dim, src, OUT_BITS[out], kernel, cap)


@dataclass(frozen=True)
class LineGeometry:
    row: RowGeometry  # the requantization geometry (always 16-byte vectors)
    lanes_per_line: int  # consecutive lanes whose chunks make up one line
    lines: int  # lines per row

    def line_of(self, vector: int, lane: int):
        """The line whose codes (vector, lane) holds, or None past the row."""
        chunk = vector * self.row.lanes + lane
        return chunk // self.lanes_per_line if chunk < self.row.chunks else None


def line_geometry(head_dim: int, src: str, kernel: str = "line_geometry") -> LineGeometry:
    """The cxl encode's layout: rows of ``head_dim`` (a multiple of 64)
    ``src`` values ("f32" or "bf16") quantized to int8, each 64-code line
    held by ``lanes_per_line`` consecutive lanes of one vector slot."""
    if src not in ("f32", "bf16"):
        raise ValueError(f"{kernel}: pages must be f32 or bf16, got {src!r}")
    if head_dim % LINE_CODES or not 0 < head_dim <= MAX_HEAD_DIM:
        raise ValueError(f"{kernel}: head_dim {head_dim} must be a multiple of {LINE_CODES} "
                         f"and <= {MAX_HEAD_DIM}")
    row = row_geometry(head_dim, src, 8, kernel)
    assert row.vec_bytes == VEC_BYTES  # a line is 128 or 256 bytes of source
    lanes_per_line = LINE_CODES * SRC_BITS[src] // 8 // VEC_BYTES
    return LineGeometry(row=row, lanes_per_line=lanes_per_line,
                        lines=head_dim // LINE_CODES)
