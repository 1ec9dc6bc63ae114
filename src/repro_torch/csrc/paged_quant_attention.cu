// Paged decode attention over ONE quantized pool (flash partials), for
// sm_90a.
//
// Replaces the Pallas kernel
// repro/kernels/paged_attention.py::paged_quant_attention
// (_paged_attn_kernel), the per-pool path of ops.tiered_decode_attention
// under use_fused(False): one launch per (pool, layer, decode step). For each
// sequence b it walks the rows p < MP of page_table[b]:
//   rows p < n_pages[b]  run the pool-row step of pool_row.cuh on page
//                        table[b, p] of the int8 (bits 8) or int4 (bits 4)
//                        pool: the online softmax (acc, m, l) of every head,
//                        and the page's mass = sum exp(s - base) at its local
//                        base = max s over (kv, g, t);
//   rows p >= n_pages[b] write mass 0 and base -1e30 (never read the table);
// then writes the UNNORMALIZED acc, l, and m with the per-pool convention of
// the Pallas kernel: m = 0 where l == 0 (an empty pool), the running max
// otherwise. The caller merges the partials (ops / ref.merge_partials).
//
// Design: the fused kernel's, without the tier codes: one block per
// sequence, one warp per head, lanes over head-dim pairs, the pool-row step
// shared through pool_row.cuh (no second copy of it).
//
// Bound: bytes. Each valid page's K and V payload and scales are read once,
// q once, the partials written once. One block per sequence fills B of 132
// SMs and walks pages serially, so at a small batch the kernel is
// latency-bound far above that bound, as the fused kernel is.
#include <cuda_runtime.h>

#include "int4.cuh"
#include "pool_row.cuh"

__global__ void paged_quant_attention_kernel(
    const float* __restrict__ q,  // [B, H, hd]
    const void* __restrict__ kpay, const float* __restrict__ ksc,  // [P, T, KV, hd(/2)], [P, T, KV]
    const void* __restrict__ vpay, const float* __restrict__ vsc,
    const int* __restrict__ table,    // [B, MP]
    const int* __restrict__ n_pages,  // [B]
    float* __restrict__ out,          // [B, H, hd] unnormalized
    float* __restrict__ m_out, float* __restrict__ l_out,        // [B, H]
    float* __restrict__ mass_out, float* __restrict__ base_out,  // [B, MP]
    int H, int KV, int hd, int T, int MP, int is8, float qdiv) {
  extern __shared__ float smem[];
  float* qs = smem;            // [H, hd]  q / sqrt(hd)
  float* acc = qs + H * hd;    // [H, hd]
  float* sc = acc + H * hd;    // [H, T]
  float* run_m = sc + H * T;   // [H]
  float* run_l = run_m + H;    // [H]
  float* hmax = run_l + H;     // [H]
  float* hmass = hmax + H;     // [H]
  const PoolRowSmem row{qs, acc, sc, run_m, run_l, hmax, hmass, T};

  const int b = blockIdx.x;
  for (int i = threadIdx.x; i < H * hd; i += blockDim.x) {
    qs[i] = q[(long long)b * H * hd + i] / qdiv;
    acc[i] = 0.f;
  }
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    run_m[h] = REPRO_NEG_INF;
    run_l[h] = 0.f;
  }
  __syncthreads();

  const int n = n_pages[b];
  for (int p = 0; p < MP; ++p) {
    if (p < n) {
      const long long slot = table[b * MP + p];
      pool_row_step(row, is8 != 0, kpay, ksc, vpay, vsc, slot, H, KV, hd, T,
                    mass_out + b * MP + p, base_out + b * MP + p);
    } else if (threadIdx.x == 0) {
      mass_out[b * MP + p] = 0.f;
      base_out[b * MP + p] = REPRO_NEG_INF;
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < H * hd; i += blockDim.x) {
    out[(long long)b * H * hd + i] = acc[i];
  }
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    m_out[b * H + h] = run_l[h] > 0.f ? run_m[h] : 0.f;
    l_out[b * H + h] = run_l[h];
  }
}

// Shapes as in the Pallas kernel; every pointer is a contiguous device
// buffer and every valid table entry addresses a row of the pool (the
// wrapper checks). qdiv is sqrt(hd) rounded to f32. Returns
// cudaGetLastError() after the launch.
extern "C" int paged_quant_attention_launch(
    const void* q, const void* kpay, const void* ksc, const void* vpay, const void* vsc,
    const void* table, const void* n_pages, void* out, void* m, void* l, void* mass,
    void* base, int B, int H, int KV, int hd, int T, int MP, int bits, float qdiv,
    void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (bits != 8 && bits != 4) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)2 * H * hd + (size_t)H * T + 4 * (size_t)H);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(paged_quant_attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int nwarps = H < 32 ? H : 32;
  paged_quant_attention_kernel<<<B, nwarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), kpay, static_cast<const float*>(ksc), vpay,
      static_cast<const float*>(vsc), static_cast<const int*>(table),
      static_cast<const int*>(n_pages), static_cast<float*>(out), static_cast<float*>(m),
      static_cast<float*>(l), static_cast<float*>(mass), static_cast<float*>(base), H, KV, hd,
      T, MP, bits == 8 ? 1 : 0, qdiv);
  return (int)cudaGetLastError();
}
