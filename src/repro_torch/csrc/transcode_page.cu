// Fused KV-page transcode (tier-to-tier requantization, int8 <-> int4), for
// sm_90a.
//
// Replaces the Pallas kernel repro/kernels/transcode_page.py::transcode_pages
// (_transcode_kernel). One warp per (page, token, kv-head) row: dequantize
// with the old scale (q * scale, f32), take the new absmax scale and
// requantize, all in registers, so the dense page never reaches device
// memory. The result is byte-equal to dequant -> quant (kernels/ref.py).
//
// Bound: bytes. A row reads its payload and scale once and writes the new
// payload and scale once; the arithmetic is a few operations per element.
// Coalesced pair loads, the row held in registers across the two passes.
#include <cuda_runtime.h>

#include "int4.cuh"

template <int SRC, int DST>
__global__ void transcode_rows_kernel(const void* __restrict__ src, const float* __restrict__ scales,
                                      void* __restrict__ dst, float* __restrict__ new_scales,
                                      long long rows, int hd) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int npairs = hd >> 1;
  const float old_scale = scales[row];
  const float qmax = DST == 8 ? 127.f : 7.f;

  float2 v[MAX_PAIRS_PER_LANE];
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < MAX_PAIRS_PER_LANE; ++j) {
    const int i = lane + 32 * j;
    if (i < npairs) {
      float q0, q1;
      if (SRC == 8) {
        const char2 c = reinterpret_cast<const char2*>(src)[row * npairs + i];
        q0 = (float)c.x;
        q1 = (float)c.y;
      } else {
        const uint8_t b = reinterpret_cast<const uint8_t*>(src)[row * npairs + i];
        q0 = int4_lo(b);
        q1 = int4_hi(b);
      }
      v[j].x = q0 * old_scale;
      v[j].y = q1 * old_scale;
      amax = fmaxf(amax, fmaxf(fabsf(v[j].x), fabsf(v[j].y)));
    }
  }
  amax = warp_max(amax);
  const float scale = quant_scale(amax, qmax);
#pragma unroll
  for (int j = 0; j < MAX_PAIRS_PER_LANE; ++j) {
    const int i = lane + 32 * j;
    if (i < npairs) {
      const float q0 = quantize(v[j].x, scale, qmax);
      const float q1 = quantize(v[j].y, scale, qmax);
      if (DST == 8) {
        char2 c;
        c.x = (signed char)q0;
        c.y = (signed char)q1;
        reinterpret_cast<char2*>(dst)[row * npairs + i] = c;
      } else {
        reinterpret_cast<uint8_t*>(dst)[row * npairs + i] = pack_int4(q0, q1);
      }
    }
  }
  if (lane == 0) new_scales[row] = scale;
}

// src: [rows, hd] int8 (src_bits 8) or [rows, hd/2] uint8 (src_bits 4);
// scales, new_scales: [rows] f32; dst at dst_bits. rows = P * T * KV.
// Same-width transcode is the identity and never reaches this function.
extern "C" int transcode_pages_launch(const void* src, const void* scales, void* dst,
                                      void* new_scales, long long rows, int hd, int src_bits,
                                      int dst_bits, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  if (src_bits == dst_bits) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int warps = 8;
  const unsigned blocks = (unsigned)((rows + warps - 1) / warps);
  const float* sc = static_cast<const float*>(scales);
  float* nsc = static_cast<float*>(new_scales);
  if (src_bits == 8) {
    transcode_rows_kernel<8, 4><<<blocks, warps * 32, 0, s>>>(src, sc, dst, nsc, rows, hd);
  } else {
    transcode_rows_kernel<4, 8><<<blocks, warps * 32, 0, s>>>(src, sc, dst, nsc, rows, hd);
  }
  return (int)cudaGetLastError();
}
