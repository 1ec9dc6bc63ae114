// The tiered decode step's per-layer glue, for sm_90a: RMSNorm, the QKV
// epilogue (biases, qk-norm, RoPE and the recent-window row write) and
// SiLU(gate) * up.
//
// Replaces no Pallas kernel: the JAX package leaves these ops to XLA, which
// fuses them inside its jitted step. Eager PyTorch runs each as a chain of
// small kernels (a norm is seven, the QKV epilogue some forty, the window
// write six), and the captured step replays them back to back, each at the
// launch floor of a tiny kernel. Each kernel here does one chain in one
// launch.
//
// Bound: launches, then bytes. At decode the operands are a few rows
// ([B, D] with B <= 8, one token a slot), so every kernel reads its inputs
// once and writes its outputs once, and its time is the launch's. The
// design keeps each row's reduction inside one block (RMSNorm) or one warp
// (a head of the epilogue: the qk-norm's sum of squares by shuffles, each
// lane holding the (i, i + hd/2) pairs that RoPE rotates together), so no
// kernel needs a second pass or an atomic.
//
// Numbers: each op is the plain version's op in f32 (kernels/decode_glue.py),
// in its order, through the IEEE intrinsics (__fmul_rn, __fadd_rn,
// __fdiv_rn, __fsqrt_rn) so that nothing is contracted into an FMA; a value
// rounds to the activation type where the plain version casts it. Only the
// order of a sum of squares differs, so a norm's output is within one ulp of
// the activation type; RoPE, the biases and SiLU * up follow the plain ops
// exactly (expf, like PyTorch's own SiLU on the card).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float load(const bf16* p, long long i) { return __bfloat162float(p[i]); }
__device__ __forceinline__ float load(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ void store(bf16* p, long long i, float v) { p[i] = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store(float* p, long long i, float v) { p[i] = v; }

// ``v`` rounded to the activation type T and back: a cast of the plain version.
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ float block_sum(float v) {
  __shared__ float part[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = threadIdx.x < ((blockDim.x + 31) >> 5) ? part[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) part[0] = v;
  }
  __syncthreads();
  return part[0];
}

// rsqrt(mean + eps) as the plain version computes it: 1 / sqrt, both IEEE.
__device__ __forceinline__ float inv_rms(float sum_sq, int n, float eps) {
  return __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(__fdiv_rn(sum_sq, (float)n), eps)));
}

// RMSNorm's geometry: a block of kNormThreads a row, each thread holding up
// to kNormVecs 16-byte vectors of it in registers, so the row is read once,
// with every load in flight together, then scaled and stored.
constexpr int kNormThreads = 512;
constexpr int kNormVecs = 4;

// One block a row: out = x * rsqrt(mean(x^2) + eps) * w, in f32. d is a
// multiple of the vector (8 bf16 or 4 f32) and at most kNormThreads *
// kNormVecs vectors; x, w and out are 16-byte aligned (the wrapper checks).
template <typename T>
__global__ void __launch_bounds__(kNormThreads) rmsnorm_kernel(
    const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ out, int d, float eps) {
  constexpr int kN = 16 / sizeof(T);
  const int nvec = d / kN;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (long long)blockIdx.x * d);
  uint4* yr = reinterpret_cast<uint4*>(out + (long long)blockIdx.x * d);
  uint4 v[kNormVecs];
#pragma unroll
  for (int j = 0; j < kNormVecs; ++j) {
    const int i = threadIdx.x + j * kNormThreads;
    if (i < nvec) v[j] = xr[i];
  }
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < kNormVecs; ++j) {
    if (threadIdx.x + j * kNormThreads < nvec) {
      const T* e = reinterpret_cast<const T*>(&v[j]);
#pragma unroll
      for (int t = 0; t < kN; ++t) {
        const float f = load(e, t);
        ss = __fadd_rn(ss, __fmul_rn(f, f));
      }
    }
  }
  const float r = inv_rms(block_sum(ss), d, eps);
#pragma unroll
  for (int j = 0; j < kNormVecs; ++j) {
    const int i = threadIdx.x + j * kNormThreads;
    if (i < nvec) {
      const T* e = reinterpret_cast<const T*>(&v[j]);
      const float4* wv = reinterpret_cast<const float4*>(w + (long long)i * kN);
      float wf[kN];
#pragma unroll
      for (int t = 0; t < kN / 4; ++t) {
        const float4 q = wv[t];
        wf[4 * t] = q.x;
        wf[4 * t + 1] = q.y;
        wf[4 * t + 2] = q.z;
        wf[4 * t + 3] = q.w;
      }
      uint4 o;
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int t = 0; t < kN; ++t) store(oe, t, __fmul_rn(__fmul_rn(load(e, t), r), wf[t]));
      yr[i] = o;
    }
  }
}

constexpr int kMaxPairsPerLane = 4;  // head_dim <= 256

// One warp a head row of one slot: the H query heads, then the KV key heads,
// then the KV value heads. q: bias, qk-norm, RoPE, stored to q_out. k: the
// same, stored to row recent_len[b] of the slot's window. v: bias, stored to
// that row. A row at or beyond the window (or below 0) writes no k or v.
template <typename T>
__global__ void qkv_epilogue_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ bq, const T* __restrict__ bk, const T* __restrict__ bv,
    const float* __restrict__ q_norm, const float* __restrict__ k_norm,
    const float* __restrict__ rope_cos, const float* __restrict__ rope_sin,
    const int* __restrict__ recent_len, T* __restrict__ q_out, bf16* __restrict__ recent_k,
    bf16* __restrict__ recent_v, int batch, int h, int kv, int hd, int r, float eps) {
  const int per_slot = h + 2 * kv;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= batch * per_slot) return;
  const int lane = threadIdx.x & 31;
  const int b = row / per_slot, j = row % per_slot, half = hd >> 1;
  const int kind = j < h ? 0 : (j < h + kv ? 1 : 2);  // q, k, v
  const int head = kind == 0 ? j : (kind == 1 ? j - h : j - h - kv);
  const int heads = kind == 0 ? h : kv;
  const T* src = (kind == 0 ? q : (kind == 1 ? k : v)) + ((long long)b * heads + head) * hd;
  const T* bias = kind == 0 ? bq : (kind == 1 ? bk : bv);
  const float* norm_w = kind == 0 ? q_norm : (kind == 1 ? k_norm : nullptr);

  float x1[kMaxPairsPerLane], x2[kMaxPairsPerLane];
#pragma unroll
  for (int i = 0; i < kMaxPairsPerLane; ++i) {
    const int p = lane + 32 * i;
    x1[i] = x2[i] = 0.f;
    if (p < half) {
      x1[i] = load(src, p);
      x2[i] = load(src, p + half);
      if (bias != nullptr) {
        const T* bh = bias + (long long)head * hd;
        x1[i] = round_to<T>(__fadd_rn(x1[i], load(bh, p)));
        x2[i] = round_to<T>(__fadd_rn(x2[i], load(bh, p + half)));
      }
    }
  }
  if (norm_w != nullptr) {
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxPairsPerLane; ++i)
      ss = __fadd_rn(ss, __fadd_rn(__fmul_rn(x1[i], x1[i]), __fmul_rn(x2[i], x2[i])));
    const float rr = inv_rms(warp_sum(ss), hd, eps);
#pragma unroll
    for (int i = 0; i < kMaxPairsPerLane; ++i) {
      const int p = lane + 32 * i;
      if (p < half) {
        x1[i] = round_to<T>(__fmul_rn(__fmul_rn(x1[i], rr), norm_w[p]));
        x2[i] = round_to<T>(__fmul_rn(__fmul_rn(x2[i], rr), norm_w[p + half]));
      }
    }
  }
  if (kind < 2) {
    const float* cb = rope_cos + (long long)b * half;
    const float* sb = rope_sin + (long long)b * half;
#pragma unroll
    for (int i = 0; i < kMaxPairsPerLane; ++i) {
      const int p = lane + 32 * i;
      if (p < half) {
        const float c = cb[p], s = sb[p];
        const float a = x1[i], e = x2[i];
        x1[i] = round_to<T>(__fsub_rn(__fmul_rn(a, c), __fmul_rn(e, s)));
        x2[i] = round_to<T>(__fadd_rn(__fmul_rn(e, c), __fmul_rn(a, s)));
      }
    }
  }
  if (kind == 0) {
    T* dst = q_out + ((long long)b * h + head) * hd;
#pragma unroll
    for (int i = 0; i < kMaxPairsPerLane; ++i) {
      const int p = lane + 32 * i;
      if (p < half) {
        store(dst, p, x1[i]);
        store(dst, p + half, x2[i]);
      }
    }
    return;
  }
  const int at = recent_len[b];
  if (at < 0 || at >= r) return;
  bf16* dst = (kind == 1 ? recent_k : recent_v) + (((long long)b * r + at) * kv + head) * hd;
#pragma unroll
  for (int i = 0; i < kMaxPairsPerLane; ++i) {
    const int p = lane + 32 * i;
    if (p < half) {
      dst[p] = __float2bfloat16_rn(x1[i]);
      dst[p + half] = __float2bfloat16_rn(x2[i]);
    }
  }
}

// out = round(SiLU(gate)) * up, SiLU(g) = g / (1 + exp(-g)) in f32.
template <typename T>
__global__ void silu_mul_kernel(const T* __restrict__ gate, const T* __restrict__ up,
                                T* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float g = load(gate, i);
    const float s = round_to<T>(__fdiv_rn(g, __fadd_rn(1.f, expf(-g))));
    store(out, i, __fmul_rn(s, load(up, i)));
  }
}

constexpr int kThreads = 256;

}  // namespace

// x, out: [rows, d] bf16 (is_bf16 1) or f32; w: [d] f32; 16-byte aligned,
// d a multiple of 16 bytes of x's type and at most kNormThreads * kNormVecs
// such vectors (kernels/decode_glue.py's ``rmsnorm_max_d``).
extern "C" int rmsnorm_launch(const void* x, const void* w, void* out, long long rows, int d,
                              float eps, int is_bf16, void* stream) {
  const int vec = is_bf16 ? 8 : 4;
  if (d <= 0 || d % vec || d / vec > kNormThreads * kNormVecs) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  if (is_bf16) {
    rmsnorm_kernel<bf16><<<(unsigned)rows, kNormThreads, 0, st>>>(
        static_cast<const bf16*>(x), wf, static_cast<bf16*>(out), d, eps);
  } else {
    rmsnorm_kernel<float><<<(unsigned)rows, kNormThreads, 0, st>>>(
        static_cast<const float*>(x), wf, static_cast<float*>(out), d, eps);
  }
  return (int)cudaGetLastError();
}

// q: [B, H, hd], k, v: [B, KV, hd] (bf16 or f32, as q_out); bq: [H, hd],
// bk, bv: [KV, hd] of the same type, or all null; q_norm, k_norm: [hd] f32,
// or both null; rope_cos, rope_sin: [B, hd/2] f32; recent_len: [B] int32; recent_k,
// recent_v: [B, R, KV, hd] bf16, written in place at one row a slot.
extern "C" int qkv_epilogue_launch(const void* q, const void* k, const void* v, const void* bq,
                                   const void* bk, const void* bv, const void* q_norm,
                                   const void* k_norm, const void* rope_cos, const void* rope_sin,
                                   const void* recent_len, void* q_out, void* recent_k,
                                   void* recent_v, int batch, int h, int kv, int hd, int r,
                                   float eps, int is_bf16, void* stream) {
  if (hd <= 0 || hd % 2 || hd / 2 > 32 * kMaxPairsPerLane) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)batch * (h + 2 * kv);
  if (rows <= 0) return (int)cudaSuccess;
  constexpr int kWarps = kThreads / 32;
  const unsigned grid = (unsigned)((rows + kWarps - 1) / kWarps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qn = static_cast<const float*>(q_norm);
  const float* kn = static_cast<const float*>(k_norm);
  const float* c = static_cast<const float*>(rope_cos);
  const float* s = static_cast<const float*>(rope_sin);
  const int* rl = static_cast<const int*>(recent_len);
  bf16* rk = static_cast<bf16*>(recent_k);
  bf16* rv = static_cast<bf16*>(recent_v);
  if (is_bf16) {
    qkv_epilogue_kernel<bf16><<<grid, kThreads, 0, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(bq), static_cast<const bf16*>(bk), static_cast<const bf16*>(bv),
        qn, kn, c, s, rl, static_cast<bf16*>(q_out), rk, rv, batch, h, kv, hd, r, eps);
  } else {
    qkv_epilogue_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(bq), static_cast<const float*>(bk),
        static_cast<const float*>(bv), qn, kn, c, s, rl, static_cast<float*>(q_out), rk, rv,
        batch, h, kv, hd, r, eps);
  }
  return (int)cudaGetLastError();
}

// gate, up, out: [n] bf16 (is_bf16 1) or f32.
extern "C" int silu_mul_launch(const void* gate, const void* up, void* out, long long n,
                               int is_bf16, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 8) blocks = 132 * 8;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    silu_mul_kernel<bf16><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const bf16*>(gate), static_cast<const bf16*>(up), static_cast<bf16*>(out), n);
  } else {
    silu_mul_kernel<float><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const float*>(gate), static_cast<const float*>(up), static_cast<float*>(out),
        n);
  }
  return (int)cudaGetLastError();
}
