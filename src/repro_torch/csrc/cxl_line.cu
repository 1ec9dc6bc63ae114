// Page codec of the cxl_hw expander tier (inline hardware line compression),
// for sm_90a: two launchers over row_group.cuh's two steps, one launch each.
//
// cxl_encode_pages replaces the Pallas kernel
// repro/kernels/cxl_line.py::cxl_encode_pages (_cxl_encode_kernel): the int8
// absmax quantization of each (page, token, kv-head) row plus the stored
// width of each 64-codeword hardware line: 4 when every |q| of the line is
// <= 7, else 8. It is row_group.cuh's requantization step at 8 bits with its
// LINES flag, the same template and guarded reciprocal as quant_pages(., 8),
// so payload and scales equal quant_pages(., 8) by construction: a row group
// of 16-byte vectors (G = 8 lanes at bf16 hd64, 16 at bf16 hd128 and f32
// hd64), rows in flight, and each line's max |code| a segmented shuffle over
// the 8 (bf16) or 16 (f32) lanes that hold it. Bound: bytes. Each row is
// read once and its payload, scale and hd/64 line widths written once
// (16,384 rows of bf16 hd64, the zamba2 page-out's layer-0 K+V: 3.28 MB,
// 0.00098 ms at 3.35 TB/s).
//
// cxl_decode_pages replaces repro/kernels/cxl_line.py::cxl_decode_pages
// (_cxl_decode_kernel): the controller decompresses inline, so decode is the
// dense int8 view times the row scale, in f32. It is row_group.cuh's dequant
// step at int8 -> f32 (dequant_rows<I8, false>, the instantiation
// dequant_pages runs for int8 -> f32), with kernels/row_group.py's
// dequant_geometry: a lane loads 4 codes (the codes of 16 output bytes), a
// row group covers a row so a warp's 16-byte stores are 512 contiguous
// bytes, and rows and their scales stay in flight on the card's resident
// blocks; each code becomes its exact float and one __fmul_rn by the scale,
// bit-equal to the plain version. Bound: bytes; each payload byte and scale
// is read once and each f32 written once (19 x 16 x 32 rows of hd64, the
// zamba2 run's largest HOST8 read: 3.15 MB, 0.00094 ms at 3.35 TB/s).
#include <cuda_runtime.h>

#include "row_group.cuh"

using row_group::Src;

// x: [rows, hd] f32 (x_is_bf16 == 0) or bf16; payload: [rows, hd] int8;
// scales: [rows] f32; line_bits: [rows, hd / 64] int32. rows = P * T * KV;
// hd a multiple of 64 and <= 256; (vec_bytes, lanes, vectors) is
// kernels/row_group.py's line_geometry. Returns the launch's error.
extern "C" int cxl_encode_pages_launch(const void* x, int x_is_bf16, void* payload, void* scales,
                                       void* line_bits, long long rows, int hd, int vec_bytes,
                                       int lanes, int vectors, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  if (hd % 64) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scales);
  int* lb = static_cast<int*>(line_bits);
  if (x_is_bf16) {
    return (int)row_group::requant_rows<Src::BF16, 8, true>(x, nullptr, payload, sc, rows, hd,
                                                            vec_bytes, lanes, vectors, s, lb);
  }
  return (int)row_group::requant_rows<Src::F32, 8, true>(x, nullptr, payload, sc, rows, hd,
                                                         vec_bytes, lanes, vectors, s, lb);
}

// payload: [rows, hd] int8; scales: [rows] f32; out: [rows, hd] f32.
// rows = P * T * KV; (vec_bytes, lanes, vectors) is kernels/row_group.py's
// dequant_geometry(hd, "int8", "f32"). Returns the launch's error.
extern "C" int cxl_decode_pages_launch(const void* payload, const void* scales, void* out,
                                       long long rows, int hd, int vec_bytes, int lanes,
                                       int vectors, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  return (int)row_group::dequant_rows<Src::I8, false>(payload, static_cast<const float*>(scales),
                                                      out, rows, hd, vec_bytes, lanes, vectors,
                                                      static_cast<cudaStream_t>(stream));
}
