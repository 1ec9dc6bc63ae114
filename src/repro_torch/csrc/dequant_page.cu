// KV-page dequantization (the tier decompress path), for sm_90a.
//
// Replaces the Pallas kernel repro/kernels/dequant_page.py::dequant_pages
// (_dequant_kernel): out[p, t, kv, d] = q[p, t, kv, d] * scale[p, t, kv],
// int4 nibbles unpacked first (int4.cuh: even index in the low nibble, two's
// complement), written as f32 or bf16 (round to nearest even). One f32
// multiply per element and no fast math, so both outputs equal the plain
// version (kernels/ref.py dequant, then a cast) bit for bit. The int8 pair
// step is shared with cxl_decode_pages (quant_row.cuh).
//
// Design: one thread per head-dim pair — a char2 of an int8 payload or one
// byte of an int4 payload — storing two outputs (float2 or bf16x2); the
// pair's row scale is one load. Neighbouring threads touch neighbouring
// pairs, so loads and stores coalesce.
//
// Bound: bytes. Each payload byte and scale is read once and each output
// written once; the arithmetic is one multiply per element.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "quant_row.cuh"

template <int BITS, bool BF16>
__global__ void dequant_pages_kernel(const void* __restrict__ payload,
                                     const float* __restrict__ scales, void* __restrict__ out,
                                     long long pairs, int npairs) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= pairs) return;
  const float s = scales[i / npairs];
  float v0, v1;
  if (BITS == 8) {
    const float2 v = dequant_int8_pair(reinterpret_cast<const char2*>(payload)[i], s);
    v0 = v.x;
    v1 = v.y;
  } else {
    const uint8_t b = reinterpret_cast<const uint8_t*>(payload)[i];
    v0 = __fmul_rn(int4_lo(b), s);
    v1 = __fmul_rn(int4_hi(b), s);
  }
  if (BF16) {
    reinterpret_cast<__nv_bfloat162*>(out)[i] = __floats2bfloat162_rn(v0, v1);
  } else {
    reinterpret_cast<float2*>(out)[i] = make_float2(v0, v1);
  }
}

// payload: [rows, hd] int8 (bits 8) or [rows, hd/2] uint8 (bits 4);
// scales: [rows] f32; out: [rows, hd] f32 (out_bf16 0) or bf16 (1).
// rows = P * T * KV. Returns cudaGetLastError() after the launch.
extern "C" int dequant_pages_launch(const void* payload, const void* scales, void* out,
                                    long long rows, int hd, int bits, int out_bf16,
                                    void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  if ((bits != 8 && bits != 4) || hd % 2) return (int)cudaErrorInvalidValue;
  const int npairs = hd / 2;
  const long long pairs = rows * npairs;
  const int threads = 256;
  const unsigned blocks = (unsigned)((pairs + threads - 1) / threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scales);
  if (bits == 8) {
    if (out_bf16) {
      dequant_pages_kernel<8, true><<<blocks, threads, 0, st>>>(payload, sc, out, pairs, npairs);
    } else {
      dequant_pages_kernel<8, false><<<blocks, threads, 0, st>>>(payload, sc, out, pairs, npairs);
    }
  } else {
    if (out_bf16) {
      dequant_pages_kernel<4, true><<<blocks, threads, 0, st>>>(payload, sc, out, pairs, npairs);
    } else {
      dequant_pages_kernel<4, false><<<blocks, threads, 0, st>>>(payload, sc, out, pairs, npairs);
    }
  }
  return (int)cudaGetLastError();
}
