// Single-launch fused tiered decode attention, for sm_90a.
//
// Replaces the Pallas megakernel
// repro/kernels/paged_attention.py::fused_tiered_attention
// (_fused_attn_kernel). For each sequence it walks the unified page table,
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
// then the dense recent window (masked by recent_len, with the safe-shift
// guards) and the normalization out = acc / max(l, 1e-30), m = 0 where
// l == 0. Exactly one launch per (layer, decode step).
//
// Design: one block per sequence, one warp per query head (warps loop over
// heads when H > 32), lanes over head-dim pairs. The block walks the table
// rows serially, as the TPU grid's sequential page axis did; the page's
// (mass, base) needs every head's scores, so each pool row ends in a
// block-wide reduction through shared memory. q (pre-scaled), acc and the
// scores of the current row live in shared memory; a row reads only the
// class buffer its tier code names.
//
// Bound: bytes. Each valid page's int8/int4 K and V payload and scales are
// read once; a decode step does ~4 operations per byte. With one block per
// sequence a batch of B sequences fills B SMs, and the serial row walk with
// per-token warp reductions leaves the kernel latency-bound far above the
// byte bound; splitting the walk over heads or pages with a cross-block
// (mass, base) combine is the redesign that closes the gap.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "int4.cuh"

#define TIER_INT8 0
#define TIER_INT4 1
#define TIER_HOST 2

__global__ void fused_tiered_attention_kernel(
    const float* __restrict__ q,  // [B, H, hd]
    const int8_t* __restrict__ k8, const float* __restrict__ s8k,  // [P8, T, KV, hd], [P8, T, KV]
    const int8_t* __restrict__ v8, const float* __restrict__ s8v,
    const uint8_t* __restrict__ k4, const float* __restrict__ s4k,  // [P4, T, KV, hd/2]
    const uint8_t* __restrict__ v4, const float* __restrict__ s4v,
    const float* __restrict__ summary,  // [Hs, KV, hd]
    const __nv_bfloat16* __restrict__ rk,  // [B, R, KV, hd]
    const __nv_bfloat16* __restrict__ rv,
    const int* __restrict__ uni_slot,  // [B, MS]
    const int* __restrict__ uni_tier,  // [B, MS]
    const int* __restrict__ rlen,      // [B]
    float* __restrict__ out,   // [B, H, hd]
    float* __restrict__ m_out, float* __restrict__ l_out,  // [B, H]
    float* __restrict__ mass_out, float* __restrict__ base_out,  // [B, MS]
    int H, int KV, int hd, int T, int R, int MS, float qdiv, float page_tokens) {
  extern __shared__ float smem[];
  const int TR = T > R ? T : R;
  float* qs = smem;               // [H, hd]  q / sqrt(hd)
  float* acc = qs + H * hd;       // [H, hd]
  float* sc = acc + H * hd;       // [H, TR]  scores, then exp weights
  float* run_m = sc + H * TR;     // [H]
  float* run_l = run_m + H;       // [H]
  float* hmax = run_l + H;        // [H]  per-head row max (host: score)
  float* hmass = hmax + H;        // [H]  per-head local mass

  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int G = H / KV;
  const int npairs = hd >> 1;
  const int hd4 = hd >> 1;

  for (int i = threadIdx.x; i < H * hd; i += blockDim.x) {
    qs[i] = q[(long long)b * H * hd + i] / qdiv;
    acc[i] = 0.f;
  }
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    run_m[h] = REPRO_NEG_INF;
    run_l[h] = 0.f;
  }
  __syncthreads();

  for (int r = 0; r < MS; ++r) {
    const int tier = uni_tier[b * MS + r];
    const long long slot = uni_slot[b * MS + r];
    if (tier == TIER_INT8 || tier == TIER_INT4) {
      const bool is8 = tier == TIER_INT8;
      const float* ksc = (is8 ? s8k : s4k) + slot * T * KV;
      const float* vsc = (is8 ? s8v : s4v) + slot * T * KV;
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
              part += qs[h * hd + 2 * i] * (a0 * ks) + qs[h * hd + 2 * i + 1] * (a1 * ks);
            }
          }
          part = warp_sum(part);
          if (lane == 0) sc[h * TR + t] = part;
        }
      }
      __syncthreads();
      for (int h = warp; h < H; h += nwarps) {
        float mx = REPRO_NEG_INF;
        for (int t = lane; t < T; t += 32) mx = fmaxf(mx, sc[h * TR + t]);
        mx = warp_max(mx);
        if (lane == 0) hmax[h] = mx;
      }
      __syncthreads();
      float pbase = REPRO_NEG_INF;
      for (int h = 0; h < H; ++h) pbase = fmaxf(pbase, hmax[h]);
      // Online-softmax update and the page's local mass, per head.
      for (int h = warp; h < H; h += nwarps) {
        const int kvh = h / G;
        const float m_old = run_m[h];
        const float m_new = fmaxf(m_old, hmax[h]);
        const float alpha = expf(m_old - m_new);
        float esum = 0.f, lsum = 0.f;
        for (int t = lane; t < T; t += 32) {
          const float s = sc[h * TR + t];
          const float e = expf(s - m_new);
          lsum += expf(s - pbase);
          esum += e;
          sc[h * TR + t] = e;
        }
        esum = warp_sum(esum);
        lsum = warp_sum(lsum);
        __syncwarp();
#pragma unroll
        for (int j = 0; j < MAX_PAIRS_PER_LANE; ++j) {
          const int i = lane + 32 * j;
          if (i < npairs) {
            float a0 = acc[h * hd + 2 * i] * alpha;
            float a1 = acc[h * hd + 2 * i + 1] * alpha;
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
              const float e = sc[h * TR + t];
              a0 += e * (b0 * vs);
              a1 += e * (b1 * vs);
            }
            acc[h * hd + 2 * i] = a0;
            acc[h * hd + 2 * i + 1] = a1;
          }
        }
        if (lane == 0) {
          run_l[h] = run_l[h] * alpha + esum;
          run_m[h] = m_new;
          hmass[h] = lsum;
        }
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        float mass = 0.f;
        for (int h = 0; h < H; ++h) mass += hmass[h];
        mass_out[b * MS + r] = mass;
        base_out[b * MS + r] = pbase;
      }
    } else if (tier == TIER_HOST) {
      for (int h = warp; h < H; h += nwarps) {
        const float* kbar = summary + (slot * KV + h / G) * hd;
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < MAX_PAIRS_PER_LANE; ++j) {
          const int i = lane + 32 * j;
          if (i < npairs) {
            part += qs[h * hd + 2 * i] * kbar[2 * i] + qs[h * hd + 2 * i + 1] * kbar[2 * i + 1];
          }
        }
        part = warp_sum(part);
        if (lane == 0) hmax[h] = part;
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        float pbase = REPRO_NEG_INF;
        for (int h = 0; h < H; ++h) pbase = fmaxf(pbase, hmax[h]);
        float mass = 0.f;
        for (int h = 0; h < H; ++h) mass += expf(hmax[h] - pbase);
        mass_out[b * MS + r] = page_tokens * mass;
        base_out[b * MS + r] = pbase;
      }
    } else if (threadIdx.x == 0) {
      mass_out[b * MS + r] = 0.f;
      base_out[b * MS + r] = REPRO_NEG_INF;
    }
    __syncthreads();
  }

  // Dense recent window + finalization (per head, no cross-head reduction).
  const int rl = rlen[b];
  for (int h = warp; h < H; h += nwarps) {
    const int kvh = h / G;
    for (int t = 0; t < R; ++t) {
      const long long rowoff = (((long long)b * R + t) * KV + kvh) * hd;
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < MAX_PAIRS_PER_LANE; ++j) {
        const int i = lane + 32 * j;
        if (i < npairs) {
          const float2 k2 = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(rk + rowoff)[i]);
          part += qs[h * hd + 2 * i] * k2.x + qs[h * hd + 2 * i + 1] * k2.y;
        }
      }
      part = warp_sum(part);
      if (lane == 0) sc[h * TR + t] = t < rl ? part : REPRO_NEG_INF;
    }
    __syncwarp();
    float mx = REPRO_NEG_INF;
    for (int t = lane; t < R; t += 32) mx = fmaxf(mx, sc[h * TR + t]);
    mx = warp_max(mx);
    const float m_old = run_m[h];
    const float m_new = fmaxf(m_old, mx);
    // Safe shift: the recent window (rl may be 0) and the pools (all-host or
    // empty tables) can both be vacuous, so NEG_INF never enters exp.
    const float shift = m_new > REPRO_NEG_INF / 2 ? m_new : 0.f;
    const float alpha = m_old > REPRO_NEG_INF / 2 ? expf(m_old - shift) : 0.f;
    float esum = 0.f;
    for (int t = lane; t < R; t += 32) {
      const float e = t < rl ? expf(sc[h * TR + t] - shift) : 0.f;
      esum += e;
      sc[h * TR + t] = e;
    }
    esum = warp_sum(esum);
    __syncwarp();
    const float l_new = run_l[h] * alpha + esum;
    const float den = fmaxf(l_new, 1e-30f);
#pragma unroll
    for (int j = 0; j < MAX_PAIRS_PER_LANE; ++j) {
      const int i = lane + 32 * j;
      if (i < npairs) {
        float a0 = acc[h * hd + 2 * i] * alpha;
        float a1 = acc[h * hd + 2 * i + 1] * alpha;
        for (int t = 0; t < R; ++t) {
          const float e = sc[h * TR + t];
          const long long rowoff = (((long long)b * R + t) * KV + kvh) * hd;
          const float2 v2 = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(rv + rowoff)[i]);
          a0 += e * v2.x;
          a1 += e * v2.y;
        }
        float* o = out + ((long long)b * H + h) * hd;
        o[2 * i] = a0 / den;
        o[2 * i + 1] = a1 / den;
      }
    }
    if (lane == 0) {
      m_out[b * H + h] = l_new > 0.f ? m_new : 0.f;
      l_out[b * H + h] = l_new;
    }
  }
}

// Shapes as in the Pallas kernel; every pointer is a contiguous device
// buffer. qdiv is sqrt(hd) rounded to f32 (q is divided by it, as the
// reference does); page_tokens multiplies the host sentinels' mass.
// Returns cudaGetLastError() after the launch.
extern "C" int fused_tiered_attention_launch(
    const void* q, const void* k8, const void* s8k, const void* v8, const void* s8v,
    const void* k4, const void* s4k, const void* v4, const void* s4v, const void* summary,
    const void* rk, const void* rv, const void* uni_slot, const void* uni_tier,
    const void* rlen, void* out, void* m, void* l, void* mass, void* base, int B, int H,
    int KV, int hd, int T, int R, int MS, float qdiv, float page_tokens, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const int TR = T > R ? T : R;
  const size_t smem = sizeof(float) * ((size_t)2 * H * hd + (size_t)H * TR + 4 * (size_t)H);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(fused_tiered_attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int nwarps = H < 32 ? H : 32;
  fused_tiered_attention_kernel<<<B, nwarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(k8),
      static_cast<const float*>(s8k), static_cast<const int8_t*>(v8),
      static_cast<const float*>(s8v), static_cast<const uint8_t*>(k4),
      static_cast<const float*>(s4k), static_cast<const uint8_t*>(v4),
      static_cast<const float*>(s4v), static_cast<const float*>(summary),
      static_cast<const __nv_bfloat16*>(rk), static_cast<const __nv_bfloat16*>(rv),
      static_cast<const int*>(uni_slot), static_cast<const int*>(uni_tier),
      static_cast<const int*>(rlen), static_cast<float*>(out), static_cast<float*>(m),
      static_cast<float*>(l), static_cast<float*>(mass), static_cast<float*>(base), H, KV, hd,
      T, R, MS, qdiv, page_tokens);
  return (int)cudaGetLastError();
}
