// KV-page dequantization (the tier decompress path), for sm_90a.
//
// Replaces the Pallas kernel repro/kernels/dequant_page.py::dequant_pages
// (_dequant_kernel): out[p, t, kv, d] = q[p, t, kv, d] * scale[p, t, kv],
// int4 nibbles unpacked first (int4.cuh: even index in the low nibble, two's
// complement), written as f32 or bf16 (round to nearest even). Each code
// becomes its exact float and is multiplied once by __fmul_rn (no fast
// math), so both outputs equal the plain version (kernels/ref.py dequant,
// then a cast) bit for bit.
//
// Bound: bytes. Each payload byte and scale is read once and each output
// written once; the stores dominate (int4 -> f32 writes 8 bytes per payload
// byte: 5.9 MB for the qwen run's (32, 16, 20, 128) int4 -> f32 batch,
// 0.0018 ms at 3.35 TB/s). The design is row_group.cuh's dequant step, its
// vectors cut by the output: a lane loads the codes of 16 output bytes (2 B
// of int4 for f32, 4 B of int8; 4 B and 8 B for bf16; narrower where the row
// is not a multiple of them, so every even head_dim <= 256 runs), a row
// group of G lanes covers a row, so a warp's 16-byte stores are 512
// contiguous bytes; each lane keeps the next batch of rows and their scales
// in flight while it converts the current one (PRMT + FSUB, no I2F; one
// FMUL an element), on the card's resident blocks. The first design cut the
// vectors by the source (16 B of int4 -> 128 B of f32 a lane): each store
// instruction then touched 32 lines, and it ran slower than the
// one-thread-a-pair kernel before it (PERF.md, section 6).
#include <cuda_runtime.h>

#include "row_group.cuh"

using row_group::Src;

// payload: [rows, hd] int8 (bits 8) or [rows, hd/2] uint8 (bits 4);
// scales: [rows] f32; out: [rows, hd] f32 (out_bf16 0) or bf16 (1).
// rows = P * T * KV. (vec_bytes, lanes, vectors) is kernels/row_group.py's
// dequant_geometry for (hd, bits, out dtype). Returns the launch's error.
extern "C" int dequant_pages_launch(const void* payload, const void* scales, void* out,
                                    long long rows, int hd, int bits, int out_bf16,
                                    int vec_bytes, int lanes, int vectors, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scales);
  cudaError_t err = cudaErrorInvalidValue;
  if (bits == 8) {
    err = out_bf16 ? row_group::dequant_rows<Src::I8, true>(payload, sc, out, rows, hd, vec_bytes,
                                                            lanes, vectors, st)
                   : row_group::dequant_rows<Src::I8, false>(payload, sc, out, rows, hd,
                                                             vec_bytes, lanes, vectors, st);
  } else if (bits == 4) {
    err = out_bf16 ? row_group::dequant_rows<Src::I4, true>(payload, sc, out, rows, hd, vec_bytes,
                                                            lanes, vectors, st)
                   : row_group::dequant_rows<Src::I4, false>(payload, sc, out, rows, hd,
                                                             vec_bytes, lanes, vectors, st);
  }
  return (int)err;
}
