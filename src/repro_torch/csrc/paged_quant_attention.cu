// Paged decode attention over ONE quantized pool (flash partials), for
// sm_90a.
//
// Replaces the Pallas kernel
// repro/kernels/paged_attention.py::paged_quant_attention
// (_paged_attn_kernel), the per-pool path of ops.tiered_decode_attention
// under use_fused(False): one launch per (pool, layer, decode step). For each
// sequence b it covers the rows p < MP of page_table[b]:
//   rows p < n_pages[b]  page table[b, p] of the int8 (bits 8) or int4
//                        (bits 4) pool: the online softmax (acc, m, l) of
//                        every head, and the page's mass = sum exp(s - base)
//                        at its local base = max s over (kv, g, t);
//   rows p >= n_pages[b] write mass 0 and base -1e30 (never read the table);
// then writes the UNNORMALIZED acc, l, and m with the per-pool convention of
// the Pallas kernel: m = 0 where l == 0 (an empty pool), the merged running
// max otherwise. The caller merges the partials (ops / ref.merge_partials).
//
// Bound: bytes. Each valid page's K and V payload and scales are read once,
// q once, the partials written once; at the serving shapes a launch moves
// about a MB, so the time is latency.
//
// Design: the fused kernel's (attn_split.cuh, no second copy): grid (S, B),
// one cluster of S blocks per sequence, rank r takes pages
// [r n / S, (r + 1) n / S) of the valid prefix for all heads, stages each
// page with cp.async while the previous one computes, and the ranks merge
// their partials through distributed shared memory in rank order 0..S-1
// (byte-equal across launches). The cluster size follows the fused kernel's
// rule (attn_split.cuh, split_cluster) with the table's MP rows as the work.
#include "attn_split.cuh"

template <int C>
__global__ void __launch_bounds__(SPLIT_MAX_THREADS) paged_quant_attention_kernel(
    const SplitParams p) {
  split_attention<C, false>(p);
}

// Shapes as in the Pallas kernel; every pointer is a contiguous device
// buffer and every valid table entry addresses a row of the pool (the
// wrapper checks). q is f32 (q_bf16 = 0) or bf16; qdiv is sqrt(hd) rounded
// to f32. Writes the cluster size it chose to *cluster. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a shape
// the block does not take.
extern "C" int paged_quant_attention_launch(
    const void* q, const void* kpay, const void* ksc, const void* vpay, const void* vsc,
    const void* table, const void* n_pages, void* out, void* m, void* l, void* mass,
    void* base, int B, int H, int KV, int hd, int T, int MP, int bits, int q_bf16, float qdiv,
    int* cluster, void* stream) {
  if (bits != 8 && bits != 4) return (int)cudaErrorInvalidValue;
  SplitParams p = {};
  p.q = q;
  p.q_bf16 = q_bf16;
  if (bits == 8) {
    p.k8 = static_cast<const int8_t*>(kpay);
    p.v8 = static_cast<const int8_t*>(vpay);
    p.s8k = static_cast<const float*>(ksc);
    p.s8v = static_cast<const float*>(vsc);
  } else {
    p.k4 = static_cast<const uint8_t*>(kpay);
    p.v4 = static_cast<const uint8_t*>(vpay);
    p.s4k = static_cast<const float*>(ksc);
    p.s4v = static_cast<const float*>(vsc);
  }
  p.slots = static_cast<const int*>(table);
  p.lens = static_cast<const int*>(n_pages);
  p.out = static_cast<float*>(out);
  p.m_out = static_cast<float*>(m);
  p.l_out = static_cast<float*>(l);
  p.mass_out = static_cast<float*>(mass);
  p.base_out = static_cast<float*>(base);
  p.H = H;
  p.KV = KV;
  p.hd = hd;
  p.T = T;
  p.MS = MP;
  p.is8 = bits == 8;
  p.max_items = MP;
  p.qdiv = qdiv;
  p.page_tokens = 1.f;
  return split_launch(paged_quant_attention_kernel<16>, paged_quant_attention_kernel<32>, p, B,
                      MP, stream, cluster);
}
