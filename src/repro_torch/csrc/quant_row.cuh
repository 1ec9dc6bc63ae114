// Shared row steps of the cxl_hw page codec and the dequant kernel: the absmax
// quantization of one (page, token, kv-head) row by one warp (cxl_line.cu)
// and the int8 dequantization of one head-dim pair (dequant_page.cu,
// cxl_line.cu).
//
// A warp holds a row of head_dim values as element pairs: lane l keeps pair
// i = l + 32 * j in v[j], for j < MAX_PAIRS_PER_LANE (head_dim <= 256). The
// quantization is kernels/ref.py's exactly (int4.cuh: IEEE divide, rintf,
// clamp). quant_page.cu computes the same codes through its own row-group step
// (row_group.cuh); the byte-equality of cxl_encode_pages with
// quant_pages(., 8) is checked on the card (chip_smoke.py, phases 2 and 6;
// tests/test_torch_cuda.py), not shared code.
#pragma once

#include <cuda_bf16.h>

#include "int4.cuh"

template <typename T>
__device__ __forceinline__ float2 load_pair(const T* p);

template <>
__device__ __forceinline__ float2 load_pair<float>(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

template <>
__device__ __forceinline__ float2 load_pair<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Loads row ``xr`` (npairs element pairs) into v, takes the warp-wide absmax
// and quantizes v in place to codes in [-qmax, qmax]; returns the row's
// scale. Every lane of the warp must call it (the absmax is a shuffle).
template <typename T>
__device__ __forceinline__ float quant_row(const T* __restrict__ xr, int npairs, int lane,
                                           float qmax, float2 (&v)[MAX_PAIRS_PER_LANE]) {
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < MAX_PAIRS_PER_LANE; ++j) {
    const int i = lane + 32 * j;
    if (i < npairs) {
      v[j] = load_pair<T>(xr + 2 * i);
      amax = fmaxf(amax, fmaxf(fabsf(v[j].x), fabsf(v[j].y)));
    }
  }
  amax = warp_max(amax);
  const float scale = quant_scale(amax, qmax);
#pragma unroll
  for (int j = 0; j < MAX_PAIRS_PER_LANE; ++j) {
    const int i = lane + 32 * j;
    if (i < npairs) {
      v[j].x = quantize(v[j].x, scale, qmax);
      v[j].y = quantize(v[j].y, scale, qmax);
    }
  }
  return scale;
}

// Stores a row's int8 codes (from quant_row) as char2 pairs.
__device__ __forceinline__ void store_int8_row(char2* __restrict__ out, int npairs, int lane,
                                               const float2 (&q)[MAX_PAIRS_PER_LANE]) {
#pragma unroll
  for (int j = 0; j < MAX_PAIRS_PER_LANE; ++j) {
    const int i = lane + 32 * j;
    if (i < npairs) {
      char2 c;
      c.x = (signed char)q[j].x;
      c.y = (signed char)q[j].y;
      out[i] = c;
    }
  }
}

// One int8 pair times its row scale, in f32 with an IEEE multiply (no fast
// math), bit-equal to the plain version's ``q.float() * scale``.
__device__ __forceinline__ float2 dequant_int8_pair(char2 c, float s) {
  return make_float2(__fmul_rn((float)c.x, s), __fmul_rn((float)c.y, s));
}
