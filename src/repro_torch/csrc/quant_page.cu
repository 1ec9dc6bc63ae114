// KV-page block quantization (the tier compress path), for sm_90a.
//
// Replaces the Pallas kernel repro/kernels/quant_page.py::quant_pages
// (_quant_kernel). One warp per (page, token, kv-head) row of head_dim
// values: absmax by warp shuffle, then per-element IEEE divide, rint and
// clamp; int4 packs each lane's adjacent pair into one byte.
//
// Bound: bytes. Each row is read once (f32 or bf16) and its payload and one
// f32 scale written once; the arithmetic is a handful of operations per
// element. The design streams rows with coalesced pair loads and keeps the
// row in registers between the absmax and the quantization, so nothing is
// read twice.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

template <typename T, int BITS>
__global__ void quant_rows_kernel(const T* __restrict__ x, void* __restrict__ payload,
                                  float* __restrict__ scales, long long rows, int hd) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int npairs = hd >> 1;
  const T* xr = x + row * hd;
  const float qmax = BITS == 8 ? 127.f : 7.f;

  float2 v[MAX_PAIRS_PER_LANE];
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
      const float q0 = quantize(v[j].x, scale, qmax);
      const float q1 = quantize(v[j].y, scale, qmax);
      if (BITS == 8) {
        char2 c;
        c.x = (signed char)q0;
        c.y = (signed char)q1;
        reinterpret_cast<char2*>(payload)[row * npairs + i] = c;
      } else {
        reinterpret_cast<uint8_t*>(payload)[row * npairs + i] = pack_int4(q0, q1);
      }
    }
  }
  if (lane == 0) scales[row] = scale;
}

template <typename T>
static void launch(const void* x, void* payload, float* scales, long long rows, int hd,
                   int bits, cudaStream_t stream) {
  const int warps = 8;
  const long long blocks = (rows + warps - 1) / warps;
  if (bits == 8) {
    quant_rows_kernel<T, 8><<<(unsigned)blocks, warps * 32, 0, stream>>>(
        static_cast<const T*>(x), payload, scales, rows, hd);
  } else {
    quant_rows_kernel<T, 4><<<(unsigned)blocks, warps * 32, 0, stream>>>(
        static_cast<const T*>(x), payload, scales, rows, hd);
  }
}

// x: [rows, hd] f32 (x_is_bf16 == 0) or bf16; payload: [rows, hd] int8 or
// [rows, hd/2] uint8; scales: [rows] f32. rows = P * T * KV.
extern "C" int quant_pages_launch(const void* x, int x_is_bf16, void* payload, void* scales,
                                  long long rows, int hd, int bits, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    launch<__nv_bfloat16>(x, payload, static_cast<float*>(scales), rows, hd, bits, s);
  } else {
    launch<float>(x, payload, static_cast<float*>(scales), rows, hd, bits, s);
  }
  return (int)cudaGetLastError();
}
