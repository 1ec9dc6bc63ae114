// Single-launch fused tiered decode attention, for sm_90a.
//
// Replaces the Pallas megakernel
// repro/kernels/paged_attention.py::fused_tiered_attention
// (_fused_attn_kernel). For each sequence it covers the unified page table,
// whose rows carry (class_row, tier_code):
//   TIER_INT8 rows  dequantize an int8 page [T, KV, hd] with its per-(t, kv)
//                   scales, TIER_INT4 rows unpack nibbles then scale; both
//                   update the online softmax (acc, m, l) of every head and
//                   emit the page's mass = sum exp(s - base) at its local
//                   base = max s, taken over (kv, g, t) together;
//   TIER_HOST rows  score the page's [KV, hd] key centroid only and emit
//                   mass = page_tokens * sum exp(s - max s) (never
//                   accumulated);
//   other rows      emit mass 0, base -1e30;
// and the dense recent window (masked by recent_len), then normalizes
// out = acc / max(l, 1e-30), m = 0 where l == 0. Exactly one launch per
// (layer, decode step).
//
// Bound: bytes. Each valid page's int8/int4 K and V payload and scales, the
// host centroids and the filled part of the recent window are read once; a
// decode step does ~4 operations per byte. At the serving shapes a launch
// moves a few MB, so the time is latency: the design keeps many pages in
// flight on many SMs.
//
// Design (attn_split.cuh, shared with the per-pool kernel): grid (S, B),
// one cluster of S blocks per sequence. Every block compacts the sequence's
// valid rows (table order) plus the recent window's chunks of T/2 tokens
// into a work list and takes its contiguous share of it, for all heads, so
// a page's (mass, base) never leaves its block. Each item is staged into
// shared memory with cp.async while the previous one computes; threads own
// (token group, head, 16 head-dim values), so loads are 16 bytes and a
// score is a few shuffles. The ranks merge their (acc, m, l) through
// distributed shared memory after cluster.sync(), in rank order 0..S-1 for
// every output, so the result does not depend on which block finished
// first: two launches on the same inputs are byte-equal.
//
// Cluster size: S in {1, 2, 4, 8, 16} with 2 S <= MS + recent chunks and
// S * B <= SMs, minimizing ceil(B / active(S)) / S where active(S) is what
// cudaOccupancyMaxActiveClusters allows at this block's shared memory (a
// wave of clusters per unit of work); ties go to the smaller S. At B = 2 on
// 132 SMs that is S = 16 (32 SMs stream one layer's pages).
#include "attn_split.cuh"

template <int C>
__global__ void __launch_bounds__(SPLIT_MAX_THREADS) fused_tiered_attention_kernel(
    const SplitParams p) {
  split_attention<C, true>(p);
}

// Shapes as in the Pallas kernel; every pointer is a contiguous device
// buffer. q is f32 (q_bf16 = 0) or bf16; qdiv is sqrt(hd) rounded to f32 (q
// is divided by it, as the reference does); page_tokens multiplies the host
// sentinels' mass. Writes the cluster size it chose to *cluster. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a shape
// the block does not take (hd / 16 or hd / 32 a power of two with
// H * hd / 32 <= 512 threads; the block's shared memory under the card's
// limit).
extern "C" int fused_tiered_attention_launch(
    const void* q, const void* k8, const void* s8k, const void* v8, const void* s8v,
    const void* k4, const void* s4k, const void* v4, const void* s4v, const void* summary,
    const void* rk, const void* rv, const void* uni_slot, const void* uni_tier,
    const void* rlen, void* out, void* m, void* l, void* mass, void* base, int B, int H,
    int KV, int hd, int T, int R, int MS, int q_bf16, float qdiv, float page_tokens,
    int* cluster, void* stream) {
  SplitParams p = {};
  p.q = q;
  p.q_bf16 = q_bf16;
  p.k8 = static_cast<const int8_t*>(k8);
  p.s8k = static_cast<const float*>(s8k);
  p.v8 = static_cast<const int8_t*>(v8);
  p.s8v = static_cast<const float*>(s8v);
  p.k4 = static_cast<const uint8_t*>(k4);
  p.s4k = static_cast<const float*>(s4k);
  p.v4 = static_cast<const uint8_t*>(v4);
  p.s4v = static_cast<const float*>(s4v);
  p.summary = static_cast<const float*>(summary);
  p.rk = static_cast<const __nv_bfloat16*>(rk);
  p.rv = static_cast<const __nv_bfloat16*>(rv);
  p.slots = static_cast<const int*>(uni_slot);
  p.tiers = static_cast<const int*>(uni_tier);
  p.lens = static_cast<const int*>(rlen);
  p.out = static_cast<float*>(out);
  p.m_out = static_cast<float*>(m);
  p.l_out = static_cast<float*>(l);
  p.mass_out = static_cast<float*>(mass);
  p.base_out = static_cast<float*>(base);
  p.H = H;
  p.KV = KV;
  p.hd = hd;
  p.T = T;
  p.R = R;
  p.RT = T / 2 > 0 ? T / 2 : 1;
  p.MS = MS;
  p.max_items = MS + (R + p.RT - 1) / p.RT;
  p.qdiv = qdiv;
  p.page_tokens = page_tokens;
  return split_launch(fused_tiered_attention_kernel<16>, fused_tiered_attention_kernel<32>, p, B,
                      p.max_items, stream, cluster);
}
