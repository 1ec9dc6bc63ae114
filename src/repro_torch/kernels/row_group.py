"""Geometry of the row-group requantization kernels (``csrc/row_group.cuh``,
run by ``quant_pages`` and ``transcode_pages``).

A row is one (page, token, kv-head) vector of ``head_dim`` values. Its bytes
are cut into ``chunks`` vectors of ``vec_bytes`` each: 16 where the row
allows it, else the widest of 8, 4, 2 or 1 bytes that divides the row and
holds whole element pairs (int4 output packs pairs). A row group of
``lanes`` threads (the chunk count rounded up to a power of two, at most 32)
holds the row, each lane ``vectors`` chunks of it; a lane keeps up to
``rows_per_batch`` rows in registers (the launcher takes fewer where that
cuts the rows a lane handles in series by a tenth). The geometry depends on (head_dim, source
format, destination width) only, so the wrapper can check a pointer against
it and raise; pure Python, so the CPU tests reach it.
"""

from __future__ import annotations

from dataclasses import dataclass

# Bits of one element of each source format.
SRC_BITS = {"f32": 32, "bf16": 16, "int8": 8, "int4": 4}
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
    out_bytes: int  # code bytes a lane stores per vector

    @property
    def out_align(self) -> int:
        """Alignment the output pointer needs (stores of at most 16 bytes)."""
        return min(self.out_bytes, VEC_BYTES)


def row_geometry(head_dim: int, src: str, dst_bits: int, kernel: str = "row_geometry"
                 ) -> RowGeometry:
    """The kernel instantiation for rows of ``head_dim`` values in format
    ``src`` ("f32", "bf16", "int8" or "int4") requantized to ``dst_bits``;
    raises ValueError (naming ``kernel``) for a shape the kernels refuse."""
    if src not in SRC_BITS:
        raise ValueError(f"{kernel}: unknown source format {src!r}")
    if dst_bits not in (8, 4):
        raise ValueError(f"{kernel}: dst_bits must be 8 or 4, got {dst_bits}")
    if head_dim < 2 or head_dim % 2 or head_dim > MAX_HEAD_DIM:
        raise ValueError(f"{kernel}: head_dim {head_dim} must be even and in "
                         f"[2, {MAX_HEAD_DIM}]")
    pair_bytes = 2 * SRC_BITS[src] // 8
    row_bytes = head_dim * SRC_BITS[src] // 8
    vec = VEC_BYTES
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
                       out_bytes=elems * dst_bits // 8)
