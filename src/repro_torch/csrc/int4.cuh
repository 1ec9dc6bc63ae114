// Shared device helpers of the KV-page kernels.
//
// int4 layout (the cross-kernel invariant of kernels/packing.py): adjacent
// head-dim pairs pack into one byte, the EVEN index in the LOW nibble, both
// nibbles two's complement. Quantization follows kernels/ref.py exactly:
// scale = amax / QMAX (1 where amax == 0), q = clamp(rint(x / scale), +-QMAX)
// with IEEE division and round-half-even (never reciprocal-multiply or
// floor(x + 0.5), which flip ties). Build without --use_fast_math.
#pragma once

#include <cstdint>

#define REPRO_NEG_INF (-1e30f)

// Pairs of head-dim elements one lane handles: element pair i = lane + 32*j
// for j < MAX_PAIRS_PER_LANE, so head_dim <= 256.
constexpr int MAX_PAIRS_PER_LANE = 4;

__device__ __forceinline__ float int4_lo(uint8_t b) {
  int v = b & 0xF;
  return (float)(v >= 8 ? v - 16 : v);
}

__device__ __forceinline__ float int4_hi(uint8_t b) {
  int v = (b >> 4) & 0xF;
  return (float)(v >= 8 ? v - 16 : v);
}

__device__ __forceinline__ uint8_t pack_int4(float lo, float hi) {
  return (uint8_t)(((int)lo & 0xF) | (((int)hi & 0xF) << 4));
}

__device__ __forceinline__ float quant_scale(float amax, float qmax) {
  return amax == 0.f ? 1.f : amax / qmax;
}

__device__ __forceinline__ float quantize(float x, float scale, float qmax) {
  return fminf(fmaxf(rintf(x / scale), -qmax), qmax);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
