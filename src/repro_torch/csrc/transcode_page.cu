// Fused KV-page transcode (tier-to-tier requantization, int8 <-> int4), for
// sm_90a.
//
// Replaces the Pallas kernel repro/kernels/transcode_page.py::transcode_pages
// (_transcode_kernel): per (page, token, kv-head) row, dequantize with the old
// scale (q * scale in f32), take the new absmax scale and requantize, in
// registers, so the dense page never reaches device memory. Byte-equal to
// dequant -> quant (kernels/ref.py).
//
// Bound: bytes. A row reads its payload and scale once and writes the new
// payload and scale once (10.2 MB for a 160-page qwen1_5_4b int8 -> int4
// cohort: 0.0031 ms at 3.35 TB/s); the arithmetic is a few operations per
// element, which at these sizes is of the same order as the bytes. The design
// (row_group.cuh): a row group of G lanes holds a row in 16-byte vectors (G =
// 8 for int8 hd128, 4 for int8 hd64 and int4 hd128, 2 for int4 hd64), the new
// absmax is a log2(G)-step shuffle, the next batch of rows and their old
// scales are in flight while the current one requantizes, and the codes come
// from a reciprocal multiply (the IEEE divide only within 2^-15 of a tie).
#include <cuda_runtime.h>

#include "row_group.cuh"

using row_group::Src;

// src: [rows, hd] int8 (src_bits 8) or [rows, hd/2] uint8 (src_bits 4);
// scales, new_scales: [rows] f32; dst at dst_bits. rows = P * T * KV.
// Same-width transcode is the identity and never reaches this function.
// (vec_bytes, lanes, vectors) is kernels/row_group.py's geometry.
extern "C" int transcode_pages_launch(const void* src, const void* scales, void* dst,
                                      void* new_scales, long long rows, int hd, int src_bits,
                                      int dst_bits, int vec_bytes, int lanes, int vectors,
                                      void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scales);
  float* nsc = static_cast<float*>(new_scales);
  if (src_bits == 8 && dst_bits == 4) {
    return (int)row_group::requant_rows<Src::I8, 4>(src, sc, dst, nsc, rows, hd, vec_bytes,
                                                    lanes, vectors, s);
  }
  if (src_bits == 4 && dst_bits == 8) {
    return (int)row_group::requant_rows<Src::I4, 8>(src, sc, dst, nsc, rows, hd, vec_bytes,
                                                    lanes, vectors, s);
  }
  return (int)cudaErrorInvalidValue;
}
