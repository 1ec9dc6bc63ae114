// The split block step of paged decode attention, shared by the fused tiered
// kernel (paged_attention.cu) and the per-pool kernel
// (paged_quant_attention.cu), for sm_90a.
//
// One launch covers a batch: grid (S, B), one thread-block cluster of S
// blocks ("ranks") per sequence. A sequence's work is a list of items:
//   ITEM_INT8 / ITEM_INT4  one compressed page [T, KV, hd] of a class
//                          buffer (payload + per-(t, kv) scales),
//   ITEM_HOST              one host sentinel: the page's [KV, hd] f32 key
//                          centroid, scored for telemetry only,
//   ITEM_RECENT            RT tokens of the bf16 recent window (fused only).
// Only rows that do work become items: invalid rows and rows past n_pages
// cost one write of mass 0 / base -1e30 each. Rank r takes the contiguous
// share [r W / S, (r + 1) W / S) of the W items, for all heads, so each
// page's (mass, base), a reduction over (kv, g, t), stays inside one block.
//
// Inside a block, thread (tg, h, c) owns C head-dim values (chunk c of
// hd / C) of query head h and the tokens t = tg, tg + TG, ... of every item:
//   - q / sqrt(hd) and the unnormalized acc of its chunk live in registers;
//     m (the head's running max) is the same in every thread of the head,
//     so the TG partial accs need no rescale when they are summed;
//   - a token's [KV, hd] row is contiguous: the block copies it with
//     16-byte cp.async, and a warp reads 32 consecutive chunks of it from
//     shared memory (16 values a load: 16 B of int8, 8 B of int4, 32 B of
//     bf16), turning codes into floats without I2F;
//   - a score is a dot over the chunk, then log2(hd / C) xor shuffles
//     across the head's lanes (no 5-shuffle warp sum per token);
//   - the next item's payload and scales are copied into the other of two
//     shared-memory stages with cp.async while the current item computes
//     (one stage when two do not fit);
//   - two __syncthreads per item: one after the copy lands, one after the
//     scores are in shared memory; one warp (the item index mod the warp
//     count) then reduces the page's (mass, base) while the others run the
//     online-softmax update and the V pass.
// After its items, a rank sums its TG partials in fixed order and writes
// (acc, m, l) to its shared memory. After cluster.sync() every rank reads
// all ranks' (m, l) through distributed shared memory and forms the merge
// weights w_r = exp(m_r - m_tot) (0 where l_r == 0; m_tot = 0 where no
// rank has mass, so -1e30 - (-1e30) never reaches exp with a nonzero
// weight), then writes its slice of the heads: out = sum_r w_r acc_r in
// rank order 0..S-1, times 1 / max(l, 1e-30) in the fused kernel,
// unnormalized in the per-pool one; m = 0 where l == 0. The order of every
// sum is fixed by the inputs (no atomics, no scratch in global memory), so
// two launches on the same inputs give byte-equal outputs, and the launch
// stays one per call.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "int4.cuh"

namespace cg = cooperative_groups;

#define ITEM_INT8 0
#define ITEM_INT4 1
#define ITEM_HOST 2
#define ITEM_RECENT 3

constexpr int SPLIT_MAX_THREADS = 512;
constexpr int SPLIT_MAX_CLUSTER = 16;

// Byte offsets into the dynamic shared memory of one block.
struct SplitLayout {
  unsigned pay;    // one payload slot (K or V) of a stage
  unsigned scl;    // one scale slot of a stage
  unsigned stage;  // one stage: K, V, K scales, V scales
  unsigned sc;     // [H, T] f32 scores of the current item
  unsigned items;  // [3, max_items] int: kind, slot, table column
  unsigned lpart;  // [TG, H] f32 partial l
  unsigned rm, rl, mt, lt;  // [H] f32: this rank's m, l; merged m, l
  unsigned w;      // [SPLIT_MAX_CLUSTER, H] f32 merge weights
  unsigned am, al;  // [SPLIT_MAX_CLUSTER, H] f32 every rank's m, l
  unsigned linv;    // [H] f32 1 / max(l, 1e-30)
  unsigned cnt;    // [32] int warp counts of the item-list compaction
  unsigned total;
};

struct SplitParams {
  const void* q;  // [B, H, hd] f32 or bf16
  int q_bf16;
  const int8_t* k8;
  const float* s8k;
  const int8_t* v8;
  const float* s8v;
  const uint8_t* k4;
  const float* s4k;
  const uint8_t* v4;
  const float* s4v;
  const float* summary;                                // [Hs, KV, hd] (fused)
  const __nv_bfloat16* rk;                             // [B, R, KV, hd] (fused)
  const __nv_bfloat16* rv;
  const int* slots;  // [B, MS] unified slots (fused) / page table (per-pool)
  const int* tiers;  // [B, MS] tier codes (fused); unused by the per-pool kernel
  const int* lens;   // [B] recent_len (fused) / n_pages (per-pool)
  float* out;        // [B, H, hd]
  float* m_out;      // [B, H]
  float* l_out;
  float* mass_out;   // [B, MS]
  float* base_out;
  int H, KV, hd, T, R, RT, MS, TG, NS, is8, max_items;
  float qdiv, page_tokens;
  SplitLayout lay;
};

__host__ __device__ inline unsigned split_a16(size_t x) { return (unsigned)((x + 15) & ~size_t(15)); }

inline size_t split_max(size_t a, size_t b) { return a > b ? a : b; }

// `pe` is the floats of one token group's padded partial acc (chunks of C
// values at a stride of C + 4 floats: a warp's float4 stores and loads then
// hit distinct banks).
inline SplitLayout split_layout(int H, int KV, int hd, int T, int RT, int max_items, int TG,
                                int NS, int pe) {
  SplitLayout L;
  size_t pay = split_max((size_t)T * KV * hd, (size_t)RT * KV * hd * 2);
  pay = split_max(pay, (size_t)KV * hd * 4);
  L.pay = split_a16(pay);
  L.scl = split_a16((size_t)T * KV * 4);
  L.stage = 2 * L.pay + 2 * L.scl;
  size_t off = split_a16(split_max((size_t)NS * L.stage, (size_t)TG * pe * 4));
  L.sc = (unsigned)off;
  off = split_a16(off + (size_t)H * T * 4);
  L.items = (unsigned)off;
  off = split_a16(off + (size_t)3 * (max_items > 0 ? max_items : 1) * 4);
  L.lpart = (unsigned)off;
  off = split_a16(off + (size_t)TG * H * 4);
  L.rm = (unsigned)off;
  off = split_a16(off + (size_t)H * 4);
  L.rl = (unsigned)off;
  off = split_a16(off + (size_t)H * 4);
  L.mt = (unsigned)off;
  off = split_a16(off + (size_t)H * 4);
  L.lt = (unsigned)off;
  off = split_a16(off + (size_t)H * 4);
  L.w = (unsigned)off;
  off = split_a16(off + (size_t)SPLIT_MAX_CLUSTER * H * 4);
  L.am = (unsigned)off;
  off = split_a16(off + (size_t)SPLIT_MAX_CLUSTER * H * 4);
  L.al = (unsigned)off;
  off = split_a16(off + (size_t)SPLIT_MAX_CLUSTER * H * 4);
  L.linv = (unsigned)off;
  off = split_a16(off + (size_t)H * 4);
  L.cnt = (unsigned)off;
  L.total = (unsigned)(off + 32 * 4);
  return L;
}

// ---------------------------------------------------------------- copies
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy `bytes` from global to shared memory with the whole block: 16-byte
// cp.async where source and size allow it (every operand of the serving
// shapes), else plain byte loads (visible after the caller's
// __syncthreads).
__device__ __forceinline__ void stage_copy(void* dst, const void* src, size_t bytes) {
  const int nt = blockDim.x;
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  const uintptr_t a = reinterpret_cast<uintptr_t>(src) | (uintptr_t)bytes;
  if ((a & 15) == 0) {
    for (size_t i = (size_t)threadIdx.x * 16; i < bytes; i += (size_t)nt * 16) cp_async16(d + i, s + i);
  } else {
    for (size_t i = threadIdx.x; i < bytes; i += nt) d[i] = s[i];
  }
}

// ---------------------------------------------------------------- loads
// 16 values from shared memory into x (addresses aligned by the layout:
// hd % 16 == 0 and every slot starts on 16 bytes). int8 and int4 codes
// become floats without I2F (a quarter-rate instruction): the code, biased
// to an unsigned value, is placed in the mantissa of 2^23 and the float
// 2^23 + bias subtracted, which is exact.
__device__ __forceinline__ float biased_byte(unsigned w, unsigned sel) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650u | sel)) - 8388736.f;  // 2^23 + 128
}

__device__ __forceinline__ float biased_nibble(unsigned w, int shift) {
  return __uint_as_float(0x4B000000u | ((w >> shift) & 0xFu)) - 8388616.f;  // 2^23 + 8
}

template <int KIND>
__device__ __forceinline__ void load16(const unsigned char* base, size_t el, float* x) {
  if constexpr (KIND == ITEM_INT8) {
    const uint4 w = *reinterpret_cast<const uint4*>(base + el);
    const unsigned u[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u, w.z ^ 0x80808080u,
                           w.w ^ 0x80808080u};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int j = 0; j < 4; ++j) x[4 * k + j] = biased_byte(u[k], j);
    }
  } else if constexpr (KIND == ITEM_INT4) {
    // Nibble p of a word is element p (even index in the low nibble).
    const uint2 w = *reinterpret_cast<const uint2*>(base + el / 2);
    const unsigned u[2] = {w.x ^ 0x88888888u, w.y ^ 0x88888888u};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
#pragma unroll
      for (int j = 0; j < 8; ++j) x[8 * k + j] = biased_nibble(u[k], 4 * j);
    }
  } else if constexpr (KIND == ITEM_RECENT) {
    const uint4* p = reinterpret_cast<const uint4*>(base + el * 2);
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const uint4 w = p[v];
      const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(b2[i]);
        x[8 * v + 2 * i] = f.x;
        x[8 * v + 2 * i + 1] = f.y;
      }
    }
  } else {  // ITEM_HOST: f32 centroid
    const float4* p = reinterpret_cast<const float4*>(base + el * 4);
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const float4 f = p[v];
      x[4 * v] = f.x;
      x[4 * v + 1] = f.y;
      x[4 * v + 2] = f.z;
      x[4 * v + 3] = f.w;
    }
  }
}

// exp(x) as one MUFU.EX2 of x log2(e): relative error about 1e-7 (1 + |x|)
// against expf; exactly 0 for x = -1e30.
__device__ __forceinline__ float split_exp(float x) { return exp2f(x * 1.44269504088896341f); }

// ---------------------------------------------------------------- block
template <int C>
struct SplitThread {
  int tg, h, c, kv, lanes;
  bool active;
  float q[C];    // q / sqrt(hd), this thread's chunk
  float acc[C];  // unnormalized output, this chunk
  float m, l;    // running max of head h; this thread's share of l
};

// Copy item `it` of sequence b into stage `st`, then commit the group.
__device__ __forceinline__ void split_fetch(const SplitParams& p, const int* kinds,
                                           const int* slots, int it, int b, int rlen,
                                           unsigned char* st) {
  const int kind = kinds[it];
  const long long slot = slots[it];
  const size_t tkv = (size_t)p.T * p.KV;
  if (kind == ITEM_INT8 || kind == ITEM_INT4) {
    const bool is8 = kind == ITEM_INT8;
    const size_t pay = is8 ? tkv * p.hd : tkv * p.hd / 2;
    const unsigned char* k = is8 ? (const unsigned char*)p.k8 : p.k4;
    const unsigned char* v = is8 ? (const unsigned char*)p.v8 : p.v4;
    stage_copy(st, k + slot * pay, pay);
    stage_copy(st + p.lay.pay, v + slot * pay, pay);
    stage_copy(st + 2 * p.lay.pay, (is8 ? p.s8k : p.s4k) + slot * tkv, tkv * 4);
    stage_copy(st + 2 * p.lay.pay + p.lay.scl, (is8 ? p.s8v : p.s4v) + slot * tkv, tkv * 4);
  } else if (kind == ITEM_HOST) {
    const size_t n = (size_t)p.KV * p.hd;
    stage_copy(st, p.summary + slot * n, n * 4);
  } else {  // ITEM_RECENT: chunk `slot` of the window, valid tokens only
    const int t0 = (int)slot * p.RT;
    const int ntok = min(p.RT, rlen - t0);
    const size_t row = ((size_t)b * p.R + t0) * p.KV * p.hd;
    const size_t n = (size_t)ntok * p.KV * p.hd * 2;
    stage_copy(st, p.rk + row, n);
    stage_copy(st + p.lay.pay, p.rv + row, n);
  }
  cp_async_commit();
}

// q . row over this thread's chunk (four partial sums, no long FMA chain).
template <int C, int KIND>
__device__ __forceinline__ float chunk_dot(const SplitParams& p, const SplitThread<C>& th,
                                           const unsigned char* st, int t) {
  const size_t el = ((size_t)t * p.KV + th.kv) * p.hd + (size_t)th.c * C;
  float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int v = 0; v < C / 16; ++v) {
    float x[16];
    load16<KIND>(st, el + 16 * v, x);
#pragma unroll
    for (int i = 0; i < 16; ++i) a[i & 3] += th.q[16 * v + i] * x[i];
  }
  return (a[0] + a[1]) + (a[2] + a[3]);
}

// Scores of one item into sc[h, t] (its valid tokens), two tokens a step.
template <int C, int KIND>
__device__ __forceinline__ void split_scores(const SplitParams& p, const SplitThread<C>& th,
                                             const unsigned char* st, float* sc, int ntok) {
  const float* ks = reinterpret_cast<const float*>(st + 2 * p.lay.pay);
  const int J = (ntok + p.TG - 1) / p.TG;
  for (int j = 0; j < J; j += 2) {
    const int t0 = th.tg + j * p.TG, t1 = t0 + p.TG;
    const bool ok0 = th.active && t0 < ntok;
    const bool ok1 = th.active && j + 1 < J && t1 < ntok;
    float s0 = ok0 ? chunk_dot<C, KIND>(p, th, st, t0) : 0.f;
    float s1 = ok1 ? chunk_dot<C, KIND>(p, th, st, t1) : 0.f;
    if (KIND == ITEM_INT8 || KIND == ITEM_INT4) {
      if (ok0) s0 *= ks[t0 * p.KV + th.kv];
      if (ok1) s1 *= ks[t1 * p.KV + th.kv];
    }
    for (int o = th.lanes >> 1; o > 0; o >>= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    }
    if (th.c == 0) {
      if (ok0) sc[th.h * p.T + t0] = s0;
      if (ok1) sc[th.h * p.T + t1] = s1;
    }
  }
}

// Online-softmax update and V pass of one pool page or recent chunk.
template <int C, int KIND>
__device__ __forceinline__ void split_values(const SplitParams& p, SplitThread<C>& th,
                                             const unsigned char* st, const float* sc,
                                             int ntok) {
  if (!th.active) return;
  const unsigned char* vb = st + p.lay.pay;
  const float* vs = reinterpret_cast<const float*>(st + 2 * p.lay.pay + p.lay.scl);
  const float* srow = sc + th.h * p.T;
  float mh = REPRO_NEG_INF;
  for (int t = 0; t < ntok; ++t) mh = fmaxf(mh, srow[t]);
  const float m_new = fmaxf(th.m, mh);
  const float alpha = split_exp(th.m - m_new);  // 0 before the first item (m = -1e30)
  th.l *= alpha;
#pragma unroll
  for (int i = 0; i < C; ++i) th.acc[i] *= alpha;
  for (int t0 = th.tg; t0 < ntok; t0 += 2 * p.TG) {
    const int t1 = t0 + p.TG;
    const bool two = t1 < ntok;
    const float e0 = split_exp(srow[t0] - m_new);
    const float e1 = two ? split_exp(srow[t1] - m_new) : 0.f;
    th.l += e0 + e1;
    float ev0 = e0, ev1 = e1;
    if (KIND != ITEM_RECENT) {
      ev0 *= vs[t0 * p.KV + th.kv];
      if (two) ev1 *= vs[t1 * p.KV + th.kv];
    }
    const size_t el0 = ((size_t)t0 * p.KV + th.kv) * p.hd + (size_t)th.c * C;
    const size_t el1 = ((size_t)(two ? t1 : t0) * p.KV + th.kv) * p.hd + (size_t)th.c * C;
#pragma unroll
    for (int v = 0; v < C / 16; ++v) {
      float x0[16], x1[16];
      load16<KIND>(vb, el0 + 16 * v, x0);
      load16<KIND>(vb, el1 + 16 * v, x1);
#pragma unroll
      for (int i = 0; i < 16; ++i) th.acc[16 * v + i] += ev0 * x0[i] + ev1 * x1[i];
    }
  }
  th.m = m_new;
}

// (mass, base) of a page or host row from its scores, by one warp:
// base = max over (h, t), mass = mul * sum exp(s - base).
__device__ __forceinline__ void split_page_stats(const SplitParams& p, const float* sc, int ntok,
                                                 float mul, int b, int col) {
  const int lane = threadIdx.x & 31;
  const int n = p.H * ntok;
  float mx = REPRO_NEG_INF;
  const int stride = ntok == 1 ? p.T : 1;  // host rows: one score per head
  for (int i = lane; i < n; i += 32) mx = fmaxf(mx, sc[i * stride]);
  mx = warp_max(mx);
  float s = 0.f;
  for (int i = lane; i < n; i += 32) s += split_exp(sc[i * stride] - mx);
  s = warp_sum(s);
  if (lane == 0) {
    p.mass_out[(size_t)b * p.MS + col] = mul * s;
    p.base_out[(size_t)b * p.MS + col] = mx;
  }
}

template <int C>
__device__ __forceinline__ void split_item(const SplitParams& p, SplitThread<C>& th,
                                           const int* kinds, const int* slots, const int* cols,
                                           int it, int b, int rlen, const unsigned char* st,
                                           float* sc) {
  const int kind = kinds[it];
  const int ntok = kind == ITEM_HOST ? 1
                   : kind == ITEM_RECENT ? min(p.RT, rlen - slots[it] * p.RT)
                                         : p.T;
  switch (kind) {
    case ITEM_INT8: split_scores<C, ITEM_INT8>(p, th, st, sc, ntok); break;
    case ITEM_INT4: split_scores<C, ITEM_INT4>(p, th, st, sc, ntok); break;
    case ITEM_HOST: split_scores<C, ITEM_HOST>(p, th, st, sc, ntok); break;
    default: split_scores<C, ITEM_RECENT>(p, th, st, sc, ntok); break;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  if (kind != ITEM_RECENT && warp == it % (int)(blockDim.x >> 5)) {
    split_page_stats(p, sc, ntok, kind == ITEM_HOST ? p.page_tokens : 1.f, b, cols[it]);
  }
  switch (kind) {
    case ITEM_INT8: split_values<C, ITEM_INT8>(p, th, st, sc, ntok); break;
    case ITEM_INT4: split_values<C, ITEM_INT4>(p, th, st, sc, ntok); break;
    case ITEM_RECENT: split_values<C, ITEM_RECENT>(p, th, st, sc, ntok); break;
    default: break;  // host rows are telemetry only
  }
}

// Build the work list of sequence b in shared memory; returns W. Also
// writes (0, -1e30) to the rows without work in this rank's stripe of the
// table. FUSED: rows whose tier code is INT8 / INT4 / HOST, in table order,
// then the recent window's chunks. Per-pool: rows p < n_pages.
template <bool FUSED>
__device__ __forceinline__ int split_items(const SplitParams& p, int b, int rank, int S,
                                           int rlen, int* kinds, int* slots, int* cols,
                                           int* cnt) {
  const int nt = blockDim.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int stripe = (p.MS + S - 1) / S;
  const int s_lo = rank * stripe, s_hi = min(p.MS, s_lo + stripe);
  const size_t rowb = (size_t)b * p.MS;
  if constexpr (!FUSED) {
    const int n = min(max(p.lens[b], 0), p.MS);
    for (int r = s_lo + threadIdx.x; r < s_hi; r += nt) {
      if (r >= n) {
        p.mass_out[rowb + r] = 0.f;
        p.base_out[rowb + r] = REPRO_NEG_INF;
      }
    }
    const int lo = (int)(((long long)rank * n) / S), hi = (int)(((long long)(rank + 1) * n) / S);
    for (int i = lo + threadIdx.x; i < hi; i += nt) {
      kinds[i] = p.is8 ? ITEM_INT8 : ITEM_INT4;
      slots[i] = p.slots[rowb + i];
      cols[i] = i;
    }
    return n;
  } else {
    int W = 0;
    for (int r0 = 0; r0 < p.MS; r0 += nt) {
      const int r = r0 + threadIdx.x;
      const int tier = r < p.MS ? p.tiers[rowb + r] : -1;
      const bool valid = tier == ITEM_INT8 || tier == ITEM_INT4 || tier == ITEM_HOST;
      if (r < p.MS && !valid && r >= s_lo && r < s_hi) {
        p.mass_out[rowb + r] = 0.f;
        p.base_out[rowb + r] = REPRO_NEG_INF;
      }
      const unsigned bal = __ballot_sync(0xffffffffu, valid);
      if (lane == 0) cnt[warp] = __popc(bal);
      __syncthreads();
      int off = W, total = 0;
      for (int w = 0; w < (nt >> 5); ++w) {
        if (w < warp) off += cnt[w];
        total += cnt[w];
      }
      if (valid) {
        const int idx = off + __popc(bal & ((1u << lane) - 1u));
        kinds[idx] = tier;
        slots[idx] = p.slots[rowb + r];
        cols[idx] = r;
      }
      W += total;
      __syncthreads();
    }
    const int nrec = (rlen + p.RT - 1) / p.RT;
    for (int j = threadIdx.x; j < nrec; j += nt) {
      kinds[W + j] = ITEM_RECENT;
      slots[W + j] = j;
      cols[W + j] = -1;
    }
    return W + nrec;
  }
}

// The whole block: work list, pipelined item walk, partial sums, cluster
// merge and the outputs of this rank's heads.
template <int C, bool FUSED>
__device__ __forceinline__ void split_attention(const SplitParams& p) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int S = (int)cluster.num_blocks();
  const int b = blockIdx.y;
  const int nt = blockDim.x;
  const SplitLayout& L = p.lay;
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  int* kinds = reinterpret_cast<int*>(smem + L.items);
  int* slots = kinds + p.max_items;
  int* cols = slots + p.max_items;
  float* lpart = reinterpret_cast<float*>(smem + L.lpart);
  float* rm = reinterpret_cast<float*>(smem + L.rm);
  float* rl = reinterpret_cast<float*>(smem + L.rl);
  float* mt = reinterpret_cast<float*>(smem + L.mt);
  float* lt = reinterpret_cast<float*>(smem + L.lt);
  float* wts = reinterpret_cast<float*>(smem + L.w);
  float* am = reinterpret_cast<float*>(smem + L.am);
  float* al = reinterpret_cast<float*>(smem + L.al);
  float* linv = reinterpret_cast<float*>(smem + L.linv);
  int* cnt = reinterpret_cast<int*>(smem + L.cnt);

  // This thread's (tg, h, c).
  SplitThread<C> th;
  th.lanes = p.hd / C;
  const int units = p.H * th.lanes;
  th.active = threadIdx.x < p.TG * units;
  const int u = th.active ? threadIdx.x % units : 0;
  th.tg = th.active ? threadIdx.x / units : p.TG;
  th.h = u / th.lanes;
  th.c = u % th.lanes;
  th.kv = th.h / (p.H / p.KV);
  th.m = REPRO_NEG_INF;
  th.l = 0.f;

  const int rlen = FUSED ? min(max(p.lens[b], 0), p.R) : 0;
  const int W = split_items<FUSED>(p, b, rank, S, rlen, kinds, slots, cols, cnt);
  const int lo = (int)(((long long)rank * W) / S), hi = (int)(((long long)(rank + 1) * W) / S);
  __syncthreads();
  if (lo < hi) split_fetch(p, kinds, slots, lo, b, rlen, smem);

  // q / sqrt(hd) of this thread's chunk, loaded while the first copy flies.
  const size_t qoff = ((size_t)b * p.H + th.h) * p.hd + (size_t)th.c * C;
  const float qinv = 1.f / p.qdiv;  // q * (1 / sqrt(hd)): within an ulp of q / sqrt(hd)
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const float x = p.q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.q)[qoff + i])
                             : static_cast<const float*>(p.q)[qoff + i];
    th.q[i] = x * qinv;
    th.acc[i] = 0.f;
  }

  // Pipelined walk over this rank's items.
  for (int it = lo; it < hi; ++it) {
    cp_async_wait_all();
    __syncthreads();
    const int i = it - lo;
    if (p.NS == 2 && it + 1 < hi) split_fetch(p, kinds, slots, it + 1, b, rlen, smem + ((i + 1) & 1) * L.stage);
    split_item<C>(p, th, kinds, slots, cols, it, b, rlen, smem + (p.NS == 2 ? (i & 1) * L.stage : 0), sc);
    if (p.NS == 1 && it + 1 < hi) {
      __syncthreads();
      split_fetch(p, kinds, slots, it + 1, b, rlen, smem);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // This rank's (acc, m, l): the TG partials summed in fixed order, acc in
  // the first padded [units, C + 4] of the (now free) stage area.
  const int E = p.H * p.hd;
  const int PE = units * (C + 4);
  float* part = reinterpret_cast<float*>(smem);
  if (th.active) {
    float4* dst = reinterpret_cast<float4*>(part + (size_t)th.tg * PE + (size_t)u * (C + 4));
#pragma unroll
    for (int k = 0; k < C / 4; ++k) {
      dst[k] = make_float4(th.acc[4 * k], th.acc[4 * k + 1], th.acc[4 * k + 2], th.acc[4 * k + 3]);
    }
    if (th.c == 0) {
      lpart[th.tg * p.H + th.h] = th.l;
      if (th.tg == 0) rm[th.h] = th.m;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += nt) {
    const int pos = e + (e / C) * 4;
    float s = part[pos];
    for (int g = 1; g < p.TG; ++g) s += part[(size_t)g * PE + pos];
    part[pos] = s;
  }
  for (int h = threadIdx.x; h < p.H; h += nt) {
    float s = lpart[h];
    for (int g = 1; g < p.TG; ++g) s += lpart[g * p.H + h];
    rl[h] = s;
  }
  cluster.sync();

  // Every rank's (m, l), one distributed-shared-memory load a thread, then
  // the merge weights of every head over the ranks, in rank order.
  for (int i = threadIdx.x; i < S * p.H; i += nt) {
    am[i] = cluster.map_shared_rank(rm, i / p.H)[i % p.H];
    al[i] = cluster.map_shared_rank(rl, i / p.H)[i % p.H];
  }
  __syncthreads();
  for (int h = threadIdx.x; h < p.H; h += nt) {
    float m_tot = REPRO_NEG_INF;
    for (int r = 0; r < S; ++r) {
      if (al[r * p.H + h] > 0.f) m_tot = fmaxf(m_tot, am[r * p.H + h]);
    }
    if (!(m_tot > REPRO_NEG_INF / 2)) m_tot = 0.f;
    float l_tot = 0.f;
    for (int r = 0; r < S; ++r) {
      const float lr = al[r * p.H + h];
      const float w = lr > 0.f ? split_exp(am[r * p.H + h] - m_tot) : 0.f;
      wts[r * p.H + h] = w;
      l_tot += w * lr;
    }
    mt[h] = m_tot;
    lt[h] = l_tot;
    linv[h] = 1.f / fmaxf(l_tot, 1e-30f);
  }
  __syncthreads();

  // Outputs of this rank's slice of the heads.
  const int h0 = (int)(((long long)rank * p.H) / S), h1 = (int)(((long long)(rank + 1) * p.H) / S);
  for (int e = h0 * p.hd + threadIdx.x; e < h1 * p.hd; e += nt) {
    const int h = e / p.hd;
    const int pos = e + (e / C) * 4;
    float v[SPLIT_MAX_CLUSTER];
#pragma unroll
    for (int r = 0; r < SPLIT_MAX_CLUSTER; ++r) {
      v[r] = r < S ? cluster.map_shared_rank(part, r)[pos] : 0.f;
    }
    float a = 0.f;
#pragma unroll
    for (int r = 0; r < SPLIT_MAX_CLUSTER; ++r) {
      if (r < S) a += wts[r * p.H + h] * v[r];
    }
    p.out[(size_t)b * E + e] = FUSED ? a * linv[h] : a;
  }
  for (int h = h0 + threadIdx.x; h < h1; h += nt) {
    p.m_out[(size_t)b * p.H + h] = lt[h] > 0.f ? mt[h] : 0.f;
    p.l_out[(size_t)b * p.H + h] = lt[h];
  }
  cluster.sync();  // no rank leaves while another still reads its shared memory
}

// ---------------------------------------------------------------- launch
// Chunk width C (16 or 32 head-dim values a thread), token groups TG,
// threads, stages and shared memory of one block; false if the shape is
// not supported (hd / C must be a power of two, H * hd / C <= 512).
inline bool split_plan(SplitParams& p, int* C_out, int* nt_out, int max_smem) {
  if (p.hd <= 0 || p.H <= 0 || p.KV <= 0 || p.H % p.KV || p.T <= 0) return false;
  int C = 0;
  for (int c = 16; c <= 32; c *= 2) {
    const int lanes = p.hd / c;
    if (p.hd % c == 0 && lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0 &&
        p.H * lanes <= SPLIT_MAX_THREADS) {
      C = c;
      break;
    }
  }
  if (!C) return false;
  const int units = p.H * (p.hd / C);
  int tg = SPLIT_MAX_THREADS / units;
  p.TG = tg < 1 ? 1 : (tg > p.T ? p.T : tg);
  *nt_out = ((p.TG * units + 31) / 32) * 32;
  *C_out = C;
  for (int ns = 2; ns >= 1; --ns) {
    p.NS = ns;
    p.lay = split_layout(p.H, p.KV, p.hd, p.T, p.RT, p.max_items, p.TG, ns, units * (C + 4));
    if ((int)p.lay.total <= max_smem) return true;
  }
  return false;
}

// Cluster size S for B sequences: among S in {1, 2, 4, 8, 16} with
// S <= work_rows / 2 (a rank should get rows) and S * B <= SMs, the one
// with the fewest waves per unit of work, ceil(B / active(S)) / S, where
// active(S) is what cudaOccupancyMaxActiveClusters allows for this block;
// ties go to the smaller S (a shorter merge). Cached per shape.
template <typename K>
int split_cluster(K kernel, int B, int nt, size_t smem, int work_rows, cudaStream_t stream) {
  struct Entry {
    const void* fn;
    int B, nt, rows, dev;
    size_t smem;
    int S;
  };
  static Entry cache[32];
  static int n_cache = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  for (int i = 0; i < n_cache; ++i) {
    const Entry& e = cache[i];
    if (e.fn == (const void*)kernel && e.B == B && e.nt == nt && e.smem == smem &&
        e.rows == work_rows && e.dev == dev)
      return e.S;
  }
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int best = 1;
  double best_cost = 1e30;
  for (int S = 1; S <= SPLIT_MAX_CLUSTER; S *= 2) {
    if (S > 1 && (2 * S > work_rows || S * B > sms)) break;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(S, B, 1);
    cfg.blockDim = dim3(nt, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = S;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int active = 0;
    if (cudaOccupancyMaxActiveClusters(&active, (const void*)kernel, &cfg) != cudaSuccess ||
        active < 1) {
      cudaGetLastError();  // a refused query leaves no sticky error behind
      continue;
    }
    const double cost = (double)((B + active - 1) / active) / S;
    if (cost < best_cost) {
      best_cost = cost;
      best = S;
    }
  }
  if (n_cache < 32) cache[n_cache++] = Entry{(const void*)kernel, B, nt, work_rows, dev, smem, best};
  return best;
}

// The kernel's shared-memory limit (raised to the largest block launched so
// far) and non-portable cluster sizes, set once per kernel and device.
inline cudaError_t split_set_attributes(const void* fn, size_t smem) {
  struct Entry {
    const void* fn;
    int dev;
    size_t smem;
  };
  static Entry set[16];
  static int n_set = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  Entry* hit = nullptr;
  for (int i = 0; i < n_set; ++i) {
    if (set[i].fn == fn && set[i].dev == dev) hit = &set[i];
  }
  if (hit && hit->smem >= smem) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  if (hit) {
    hit->smem = smem;
  } else if (n_set < 16) {
    set[n_set++] = Entry{fn, dev, smem};
  }
  return cudaSuccess;
}

template <typename K>
cudaError_t split_launch_one(K kernel, const SplitParams& p, int B, int nt, int work_rows,
                             cudaStream_t stream, int* cluster_out) {
  const size_t smem = p.lay.total;
  cudaError_t e = split_set_attributes((const void*)kernel, smem);
  if (e != cudaSuccess) return e;
  const int S = split_cluster(kernel, B, nt, smem, work_rows, stream);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, B, 1);
  cfg.blockDim = dim3(nt, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) return e;
  if (cluster_out) *cluster_out = S;
  return cudaGetLastError();
}

// Plan the block for p's shape and launch the kernel instantiated for the
// chosen chunk width (k16 for C = 16, k32 for C = 32).
template <typename K16, typename K32>
int split_launch(K16 k16, K32 k32, SplitParams p, int B, int work_rows, void* stream,
                 int* cluster_out) {
  if (B <= 0) return (int)cudaSuccess;
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  int C = 0, nt = 0;
  if (!split_plan(p, &C, &nt, max_smem)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(C == 16 ? split_launch_one(k16, p, B, nt, work_rows, s, cluster_out)
                       : split_launch_one(k32, p, B, nt, work_rows, s, cluster_out));
}
