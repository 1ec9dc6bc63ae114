// Page codec of the cxl_hw expander tier (inline hardware line compression),
// for sm_90a: two kernels, each with its own launch.
//
// cxl_encode_pages replaces the Pallas kernel
// repro/kernels/cxl_line.py::cxl_encode_pages (_cxl_encode_kernel): the int8
// absmax quantization of each (page, token, kv-head) row, exactly as
// quant_pages at 8 bits (the row step of quant_row.cuh: IEEE divide, rintf,
// clamp), plus the stored width of each 64-codeword hardware line: 4 when
// every |q| of the line is <= 7, else 8. One warp per row; lane l keeps pair
// l + 32 j, so with 32 pairs to a line the lane's pair j lies in line j and a
// line's max |q| is one warp max over pair j. Payload and scales are
// byte-equal to quant_pages(., 8), the line widths to the plain version.
//
// cxl_decode_pages replaces repro/kernels/cxl_line.py::cxl_decode_pages
// (_cxl_decode_kernel): the controller decompresses inline, so decode is the
// dense int8 view times the row scale, in f32: one thread per head-dim pair,
// the int8 pair step shared with dequant_page.cu (IEEE multiply, no fast
// math), bit-equal to the plain version.
//
// Bound: bytes, both. Encode reads each row once and writes its payload, one
// scale and hd/64 line widths once; decode reads each payload byte and scale
// once and writes each f32 once. Loads and stores are coalesced pairs.
#include <cuda_runtime.h>

#include "quant_row.cuh"

constexpr int CXL_LINE_ELEMS = 64;        // int8 codewords per hardware line
constexpr float CXL_NARROW_QMAX = 7.f;    // |q| <= 7 -> the line is stored 4-bit
constexpr int CXL_LINE_PAIRS = CXL_LINE_ELEMS / 2;
static_assert(CXL_LINE_PAIRS == 32, "a line is one pair per lane of a warp");

template <typename T>
__global__ void cxl_encode_kernel(const T* __restrict__ x, char2* __restrict__ payload,
                                  float* __restrict__ scales, int* __restrict__ line_bits,
                                  long long rows, int hd) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int npairs = hd >> 1;
  const int n_lines = npairs / CXL_LINE_PAIRS;
  float2 q[MAX_PAIRS_PER_LANE];
  const float scale = quant_row<T>(x + row * hd, npairs, lane, 127.f, q);
  store_int8_row(payload + row * npairs, npairs, lane, q);
#pragma unroll
  for (int j = 0; j < MAX_PAIRS_PER_LANE; ++j) {
    if (j < n_lines) {  // warp-uniform: every lane holds a pair of line j
      const float m = warp_max(fmaxf(fabsf(q[j].x), fabsf(q[j].y)));
      if (lane == 0) line_bits[row * n_lines + j] = m <= CXL_NARROW_QMAX ? 4 : 8;
    }
  }
  if (lane == 0) scales[row] = scale;
}

__global__ void cxl_decode_kernel(const char2* __restrict__ payload,
                                  const float* __restrict__ scales, float2* __restrict__ out,
                                  long long pairs, int npairs) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= pairs) return;
  out[i] = dequant_int8_pair(payload[i], scales[i / npairs]);
}

// x: [rows, hd] f32 (x_is_bf16 == 0) or bf16; payload: [rows, hd] int8;
// scales: [rows] f32; line_bits: [rows, hd / 64] int32. rows = P * T * KV;
// hd a multiple of 64 and <= 256. Returns cudaGetLastError() after the launch.
extern "C" int cxl_encode_pages_launch(const void* x, int x_is_bf16, void* payload, void* scales,
                                       void* line_bits, long long rows, int hd, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  if (hd % CXL_LINE_ELEMS || hd > 64 * MAX_PAIRS_PER_LANE) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int warps = 8;
  const unsigned blocks = (unsigned)((rows + warps - 1) / warps);
  char2* pay = static_cast<char2*>(payload);
  float* sc = static_cast<float*>(scales);
  int* lb = static_cast<int*>(line_bits);
  if (x_is_bf16) {
    cxl_encode_kernel<__nv_bfloat16><<<blocks, warps * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), pay, sc, lb, rows, hd);
  } else {
    cxl_encode_kernel<float><<<blocks, warps * 32, 0, s>>>(static_cast<const float*>(x), pay,
                                                           sc, lb, rows, hd);
  }
  return (int)cudaGetLastError();
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
