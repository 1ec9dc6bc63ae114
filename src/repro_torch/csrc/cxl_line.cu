// Page codec of the cxl_hw expander tier (inline hardware line compression),
// for sm_90a: two kernels, each with its own launch.
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
// dense int8 view times the row scale, in f32: one thread per head-dim pair
// (IEEE multiply, no fast math), bit-equal to the plain version. Bound:
// bytes; each payload byte and scale is read once and each f32 written once.
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

// One int8 pair times its row scale, in f32 with an IEEE multiply (no fast
// math), bit-equal to the plain version's ``q.float() * scale``.
__device__ __forceinline__ float2 dequant_int8_pair(char2 c, float s) {
  return make_float2(__fmul_rn((float)c.x, s), __fmul_rn((float)c.y, s));
}

__global__ void cxl_decode_kernel(const char2* __restrict__ payload,
                                  const float* __restrict__ scales, float2* __restrict__ out,
                                  long long pairs, int npairs) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= pairs) return;
  out[i] = dequant_int8_pair(payload[i], scales[i / npairs]);
}

// payload: [rows, hd] int8; scales: [rows] f32; out: [rows, hd] f32.
// rows = P * T * KV, hd even. Returns cudaGetLastError() after the launch.
extern "C" int cxl_decode_pages_launch(const void* payload, const void* scales, void* out,
                                       long long rows, int hd, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  if (hd % 2) return (int)cudaErrorInvalidValue;
  const int npairs = hd / 2;
  const long long pairs = rows * npairs;
  const int threads = 256;
  const unsigned blocks = (unsigned)((pairs + threads - 1) / threads);
  cxl_decode_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char2*>(payload), static_cast<const float*>(scales),
      static_cast<float2*>(out), pairs, npairs);
  return (int)cudaGetLastError();
}
