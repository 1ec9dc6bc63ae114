// One compressed pool row of paged decode attention, shared by the fused
// tiered kernel (paged_attention.cu) and the per-pool kernel
// (paged_quant_attention.cu).
//
// A block owns one sequence, one warp per query head (warps loop over heads
// when H > 32), lanes over head-dim pairs. For one page [T, KV, hd] of an
// int8 or int4 class buffer the step
//   1. scores s[h, t] = q_h . (k_int[t, kv(h)] * scale[t, kv(h)]) into sc,
//   2. takes each head's row max and the page base = max over (h, t),
//   3. updates every head's online softmax (acc, run_m, run_l) with the
//      page's exp weights and V,
//   4. writes the page's mass = sum_{h,t} exp(s - base) and base (thread 0),
// with a block-wide reduction through shared memory between the phases. All
// threads of the block must call it; it ends after a __syncthreads, before
// thread 0's writes, so the caller synchronizes before reusing sc/hmax.
#pragma once

#include "int4.cuh"

struct PoolRowSmem {
  const float* qs;  // [H, hd]  q / sqrt(hd)
  float* acc;       // [H, hd]  unnormalized output
  float* sc;        // [H, TR]  scores, then exp weights
  float* run_m;     // [H]
  float* run_l;     // [H]
  float* hmax;      // [H]  per-head row max
  float* hmass;     // [H]  per-head local mass
  int TR;           // row stride of sc (>= T)
};

__device__ __forceinline__ void pool_row_step(
    const PoolRowSmem& s, bool is8, const void* __restrict__ kpay,
    const float* __restrict__ kscale, const void* __restrict__ vpay,
    const float* __restrict__ vscale, long long slot, int H, int KV, int hd, int T,
    float* __restrict__ mass_dst, float* __restrict__ base_dst) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int G = H / KV;
  const int npairs = hd >> 1;
  const int hd4 = hd >> 1;
  const int TR = s.TR;
  const int8_t* k8 = static_cast<const int8_t*>(kpay);
  const uint8_t* k4 = static_cast<const uint8_t*>(kpay);
  const int8_t* v8 = static_cast<const int8_t*>(vpay);
  const uint8_t* v4 = static_cast<const uint8_t*>(vpay);
  const float* ksc = kscale + slot * T * KV;
  const float* vsc = vscale + slot * T * KV;
  // Scores s[h, t] = q_h . (k_int[t, kv(h)] * scale[t, kv(h)]).
  for (int h = warp; h < H; h += nwarps) {
    const int kvh = h / G;
    for (int t = 0; t < T; ++t) {
      const float ks = ksc[t * KV + kvh];
      const long long rowoff = (slot * T + t) * KV + kvh;
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < MAX_PAIRS_PER_LANE; ++j) {
        const int i = lane + 32 * j;
        if (i < npairs) {
          float a0, a1;
          if (is8) {
            const char2 c = reinterpret_cast<const char2*>(k8 + rowoff * hd)[i];
            a0 = (float)c.x;
            a1 = (float)c.y;
          } else {
            const uint8_t by = k4[rowoff * hd4 + i];
            a0 = int4_lo(by);
            a1 = int4_hi(by);
          }
          part += s.qs[h * hd + 2 * i] * (a0 * ks) + s.qs[h * hd + 2 * i + 1] * (a1 * ks);
        }
      }
      part = warp_sum(part);
      if (lane == 0) s.sc[h * TR + t] = part;
    }
  }
  __syncthreads();
  for (int h = warp; h < H; h += nwarps) {
    float mx = REPRO_NEG_INF;
    for (int t = lane; t < T; t += 32) mx = fmaxf(mx, s.sc[h * TR + t]);
    mx = warp_max(mx);
    if (lane == 0) s.hmax[h] = mx;
  }
  __syncthreads();
  float pbase = REPRO_NEG_INF;
  for (int h = 0; h < H; ++h) pbase = fmaxf(pbase, s.hmax[h]);
  // Online-softmax update and the page's local mass, per head.
  for (int h = warp; h < H; h += nwarps) {
    const int kvh = h / G;
    const float m_old = s.run_m[h];
    const float m_new = fmaxf(m_old, s.hmax[h]);
    const float alpha = expf(m_old - m_new);
    float esum = 0.f, lsum = 0.f;
    for (int t = lane; t < T; t += 32) {
      const float x = s.sc[h * TR + t];
      const float e = expf(x - m_new);
      lsum += expf(x - pbase);
      esum += e;
      s.sc[h * TR + t] = e;
    }
    esum = warp_sum(esum);
    lsum = warp_sum(lsum);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < MAX_PAIRS_PER_LANE; ++j) {
      const int i = lane + 32 * j;
      if (i < npairs) {
        float a0 = s.acc[h * hd + 2 * i] * alpha;
        float a1 = s.acc[h * hd + 2 * i + 1] * alpha;
        for (int t = 0; t < T; ++t) {
          const float vs = vsc[t * KV + kvh];
          const long long rowoff = (slot * T + t) * KV + kvh;
          float b0, b1;
          if (is8) {
            const char2 c = reinterpret_cast<const char2*>(v8 + rowoff * hd)[i];
            b0 = (float)c.x;
            b1 = (float)c.y;
          } else {
            const uint8_t by = v4[rowoff * hd4 + i];
            b0 = int4_lo(by);
            b1 = int4_hi(by);
          }
          const float e = s.sc[h * TR + t];
          a0 += e * (b0 * vs);
          a1 += e * (b1 * vs);
        }
        s.acc[h * hd + 2 * i] = a0;
        s.acc[h * hd + 2 * i + 1] = a1;
      }
    }
    if (lane == 0) {
      s.run_l[h] = s.run_l[h] * alpha + esum;
      s.run_m[h] = m_new;
      s.hmass[h] = lsum;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float mass = 0.f;
    for (int h = 0; h < H; ++h) mass += s.hmass[h];
    *mass_dst = mass;
    *base_dst = pbase;
  }
}
