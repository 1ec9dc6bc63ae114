// Shared device helpers of the KV-page kernels.
//
// int4 layout (the cross-kernel invariant of kernels/packing.py): adjacent
// head-dim pairs pack into one byte, the EVEN index in the LOW nibble, both
// nibbles two's complement. Quantization follows kernels/ref.py exactly:
// scale = amax / QMAX (1 where amax == 0), q = clamp(rint(x / scale), +-QMAX)
// with round-half-even (never floor(x + 0.5), which flips ties). quantize()
// below is that formula with the IEEE divide. row_group.cuh multiplies by
// the row's reciprocal scale instead, wherever that provably rounds alike
// (more than 2^-15 from a rounding tie), and falls back to quantize()
// elsewhere, so its codes equal quantize()'s. Build without --use_fast_math.
#pragma once

#include <cstdint>

#define REPRO_NEG_INF (-1e30f)

// One byte of two codes given by their low bits (two's complement).
__device__ __forceinline__ uint8_t pack_int4_bits(uint32_t lo, uint32_t hi) {
  return (uint8_t)((lo & 0xF) | ((hi & 0xF) << 4));
}

__device__ __forceinline__ uint8_t pack_int4(float lo, float hi) {
  return pack_int4_bits((uint32_t)(int)lo, (uint32_t)(int)hi);
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
