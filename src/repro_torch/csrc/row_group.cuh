// Row-group step of the two KV-page requantization kernels, for sm_90a:
// quant_page.cu (f32/bf16 rows -> int8/int4) and transcode_page.cu (int8 <->
// int4 rows, dequantized with their old scale first). One template, one
// kernel per (source format, destination width, vector width, vectors per
// lane).
//
// A row is one (page, token, kv-head) vector of head_dim values; its bytes
// are cut into C chunks of VB bytes (VB = 16 where the row allows it, else
// the largest of 8, 4, 2, 1 bytes that divides the row and holds whole
// element pairs). A ROW GROUP of G lanes (G = C rounded up to a power of two,
// at most 32) holds the row: lane j loads chunks j + G v, v < V, one vector
// load each, so neighbouring lanes read neighbouring bytes and a warp reads
// 32 / G rows at once. The row's absmax is a __shfl_xor_sync max over
// log2(G) steps inside the group. The geometry is chosen in Python
// (kernels/row_group.py) from (head_dim, source format, destination width)
// alone; the pointers must be aligned to it, and the launcher refuses those
// that are not (no narrower path is taken at run time).
//
// Rows in flight: a lane holds up to K = 4 / V rows of a batch in registers
// and, in a grid-stride loop over batches, issues the NEXT batch's vector
// loads (and old scales) before it reduces and requantizes the current one
// (a register double buffer). The grid is the card's resident block count
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs), capped by the work;
// K drops to 2 or 1 rows where that puts a tenth fewer rows in series on a
// lane (a cohort of 400 batches on 396 resident blocks would run 2 rounds of
// 4 rows where 1600 batches of 1 take 5 rounds). At K = 4 and 16-byte vectors a thread has 64 B of loads in
// flight beside the batch it computes: per SM (ptxas, sm_90a, 16-byte
// vectors) 64 KB for f32 and bf16 rows (57 and 59 registers, 4 blocks of
// 256), 48 KB for int8 -> int4 (80 registers, 3 blocks), 32 KB for int4 ->
// int8 (127 registers, 2 blocks), against ~18 KB that 3.35 TB/s x ~0.7 us
// of latency asks of each of 132 SMs.
//
// Quantization without a divide per element: r = __frcp_rn(scale) once a
// row, y = __fmul_rn(x, r) (never contracted into an FMA). y and the
// correctly rounded quotient fl(x / scale) both lie within (2u + u^2)|q| and
// u|q| of q = x / scale (u = 2^-24), so they differ by < 3.0001 u |q| <=
// 2.3e-5 for |q| <= 127.01 (|x| <= amax); rint changes only at half-integers,
// so wherever |y - rint(y)| < 0.5 - 2^-15 the two round alike. A vector with
// any element elsewhere (NaN included: the test is written so that NaN fails
// it) is redone by exact_codes, out of line, with int4.cuh's quantize() (IEEE
// divide, rintf, clamp). A scale of 0 or one so small that 1/scale overflows
// gives r = inf, y = inf or NaN, and the exact path. So every code equals
// quantize() on every input; the scale itself is still amax / qmax by IEEE
// divide (quant_scale), and the transcode's dequant is __fmul_rn(q,
// old_scale), as the plain version's q.float() * scale.
//
// No conversion instruction per element: I2F, F2I and FRND issue at 16 a
// clock an SM, an eighth of FADD's 128, and three of them an element kept
// the first version of this step compute-bound at the card's 6.5 M-element
// cohorts. Codes become floats by adding their bits under 2^23 (Elements),
// rint is y + 1.5 * 2^23 (round to nearest even in the add), and the code is
// that sum's low bits (fast_codes).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "int4.cuh"

namespace row_group {

constexpr int BLOCK = 256;                        // threads of a block
constexpr float TIE_GUARD = 0.5f - 1.f / 32768.f;  // 0.5 - 2^-15, exact

enum class Src { F32, BF16, I8, I4 };

template <Src S>
__host__ __device__ constexpr int src_bits() {
  return S == Src::F32 ? 32 : S == Src::BF16 ? 16 : S == Src::I8 ? 8 : 4;
}

// VB raw bytes of one lane's vector as 32-bit words (VB < 4: the low bytes
// of one word, the rest zero).
template <int VB>
struct Raw {
  uint32_t w[VB >= 4 ? VB / 4 : 1];
};

template <int VB>
__device__ __forceinline__ Raw<VB> load_raw(const uint8_t* __restrict__ p) {
  Raw<VB> r;
  if constexpr (VB == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    r.w[0] = u.x; r.w[1] = u.y; r.w[2] = u.z; r.w[3] = u.w;
  } else if constexpr (VB == 8) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    r.w[0] = u.x; r.w[1] = u.y;
  } else if constexpr (VB == 4) {
    r.w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else if constexpr (VB == 2) {
    r.w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  } else {
    r.w[0] = __ldg(p);
  }
  return r;
}

// The E elements of a raw vector as exact f32 values, on the full-rate FP32
// and integer pipes only (an I2F runs at a quarter of FADD's rate, 16 a
// clock an SM): an integer code c becomes float bits 0x4B000000 | (c + bias)
// = 2^23 + c + bias, minus 2^23 + bias (exact). int4: the nibble at bits
// [4e, 4e + 4), the even index in the low nibble of its byte, two's
// complement (int4.cuh's layout); nibble ^ 8 is the code + 8.
template <Src S, int VB>
struct Elements {
  static constexpr int E = VB * 8 / src_bits<S>();
  float x[E];

  __device__ __forceinline__ explicit Elements(const Raw<VB>& r) {
    if constexpr (S == Src::F32) {
#pragma unroll
      for (int e = 0; e < E; ++e) x[e] = __uint_as_float(r.w[e]);
    } else if constexpr (S == Src::BF16) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const uint32_t w = r.w[e >> 1];
        x[e] = __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
      }
    } else if constexpr (S == Src::I8) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const uint32_t w = r.w[e >> 2] ^ 0x80808080u;  // byte = code + 128
        const uint32_t bits = __byte_perm(w, 0x4B000000u, 0x7440u | (e & 3));
        x[e] = __fsub_rn(__uint_as_float(bits), 8388736.f);  // 2^23 + 128
      }
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const uint32_t w = (r.w[e >> 3] ^ 0x88888888u) >> (4 * (e & 7));  // nibble = code + 8
        x[e] = __fsub_rn(__uint_as_float(0x4B000000u | (w & 0xFu)), 8388616.f);  // 2^23 + 8
      }
    }
  }
};

// OB bytes of codes, stored with the widest aligned stores.
template <int OB>
struct Codes {
  uint32_t w[OB >= 4 ? OB / 4 : 1];
};

template <int OB>
__device__ __forceinline__ void store_codes(uint8_t* __restrict__ p, const Codes<OB>& c) {
  if constexpr (OB == 32) {
    reinterpret_cast<uint4*>(p)[0] = make_uint4(c.w[0], c.w[1], c.w[2], c.w[3]);
    reinterpret_cast<uint4*>(p)[1] = make_uint4(c.w[4], c.w[5], c.w[6], c.w[7]);
  } else if constexpr (OB == 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(c.w[0], c.w[1], c.w[2], c.w[3]);
  } else if constexpr (OB == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(c.w[0], c.w[1]);
  } else if constexpr (OB == 4) {
    *reinterpret_cast<unsigned int*>(p) = c.w[0];
  } else if constexpr (OB == 2) {
    *reinterpret_cast<unsigned short*>(p) = (unsigned short)c.w[0];
  } else {
    *p = (uint8_t)c.w[0];
  }
}

constexpr float RINT_MAGIC = 12582912.f;  // 1.5 * 2^23: y + M is rint(y) + M for |y| < 2^22

// The codes of one vector, fast: y = x * rcp, t = y + 1.5 * 2^23 rounds y to
// the nearest integer, ties to even (FADD, full rate, where rintf and F2I run
// at a quarter), and t's low bits hold the code (t = 2^23 + 2^22 + code). No
// clamp: |x| <= amax bounds |y| by qmax (1 + 3u) < qmax + 0.5. Returns false
// where any element sits within 2^-15 of a half-integer or is not finite
// (NaN fails the test), for exact_codes to redo the vector.
template <int DST, int E, int OB>
__device__ __forceinline__ bool fast_codes(const float (&x)[E], float rcp, Codes<OB>& out) {
  bool ok = true;
  uint32_t t[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float y = __fmul_rn(x[e], rcp);
    const float tf = __fadd_rn(y, RINT_MAGIC);
    ok &= fabsf(__fsub_rn(y, __fsub_rn(tf, RINT_MAGIC))) < TIE_GUARD;
    t[e] = __float_as_uint(tf);
  }
  if constexpr (DST == 8 && E >= 4) {
#pragma unroll
    for (int e = 0; e < E; e += 4) {  // the low bytes of four codes
      out.w[e >> 2] = __byte_perm(__byte_perm(t[e], t[e + 1], 0x0040u),
                                  __byte_perm(t[e + 2], t[e + 3], 0x0040u), 0x5410u);
    }
  } else if constexpr (DST == 8) {
    out.w[0] = __byte_perm(t[0], t[1], 0x0040u);  // OB = 2: the low half word is stored
  } else {
#pragma unroll
    for (int i = 0; i < (OB >= 4 ? OB / 4 : 1); ++i) out.w[i] = 0;
#pragma unroll
    for (int e = 0; e < E; e += 2) {
      out.w[e >> 3] |= (uint32_t)pack_int4_bits(t[e], t[e + 1]) << (4 * (e & 7));
    }
  }
  return ok;
}

// The codes of one vector by int4.cuh's quantize() (IEEE divide, rintf,
// clamp), out of line: taken only where fast_codes declines.
template <Src S, int DST, int VB>
__device__ __noinline__ Codes<VB * 8 / src_bits<S>() * DST / 8> exact_codes(Raw<VB> r, float os,
                                                                           float scale) {
  constexpr bool DEQ = S == Src::I8 || S == Src::I4;
  constexpr int E = VB * 8 / src_bits<S>();
  const float qmax = DST == 8 ? 127.f : 7.f;
  const Elements<S, VB> el(r);
  float q[E];
#pragma unroll
  for (int e = 0; e < E; ++e) q[e] = quantize(DEQ ? __fmul_rn(el.x[e], os) : el.x[e], scale, qmax);
  Codes<E * DST / 8> out = {};
#pragma unroll
  for (int e = 0; e < E; e += 2) {
    if constexpr (DST == 8) {
      out.w[e >> 2] |= ((uint32_t)((int)q[e] & 0xff) | (uint32_t)((int)q[e + 1] & 0xff) << 8)
                       << (8 * (e & 3));
    } else {
      out.w[e >> 3] |= (uint32_t)pack_int4(q[e], q[e + 1]) << (4 * (e & 7));
    }
  }
  return out;
}

template <Src S, int DST, int VB, int V>
struct Rows {
  static constexpr bool DEQ = S == Src::I8 || S == Src::I4;  // transcode
  static constexpr int E = VB * 8 / src_bits<S>();            // elements a vector holds
  static constexpr int OB = E * DST / 8;                      // code bytes of a vector
  static constexpr int KMAX = 4 / V;                          // rows a lane holds

  const uint8_t* src;  // read through __ldg
  const float* old_scales;
  uint8_t* dst;
  float* new_scales;
  long long rows;
  int chunks, G, K;

  __device__ __forceinline__ long long row_of(long long b, int k, int g) const {
    return (b * K + k) * (BLOCK / G) + g;
  }

  __device__ __forceinline__ void load(long long b, int g, int j, Raw<VB> (&buf)[KMAX][V],
                                       float (&sc)[KMAX]) const {
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      const long long row = row_of(b, k, g);
      const bool ok = k < K && row < rows;
      if constexpr (DEQ) sc[k] = ok ? __ldg(old_scales + row) : 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int c = v * G + j;
        buf[k][v] = Raw<VB>{};
        if (ok && c < chunks) {
          buf[k][v] = load_raw<VB>(src + (row * chunks + c) * VB);
        }
      }
    }
  }

  // The lane's share of the row's absmax. Transcode: fabsf(q * os) is
  // RN(|q| |os|), monotone in |q|, so the largest is RN(max |q| * |os|): one
  // multiply a lane, not one an element; fmaxf(0, .) gives 0 where the
  // element pass would meet only NaN (os NaN, or os inf with every q = 0).
  __device__ __forceinline__ float lane_amax(const Raw<VB> (&buf)[V], float os) const {
    float amax = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const Elements<S, VB> el(buf[v]);
#pragma unroll
      for (int e = 0; e < E; ++e) amax = fmaxf(amax, fabsf(el.x[e]));
    }
    return DEQ ? fmaxf(0.f, __fmul_rn(amax, fabsf(os))) : amax;
  }

  __device__ __forceinline__ void requant(long long b, int g, int j,
                                          const Raw<VB> (&buf)[KMAX][V],
                                          const float (&sc)[KMAX]) const {
    const float qmax = DST == 8 ? 127.f : 7.f;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k >= K) break;  // block-uniform: every lane of the warp shuffles alike
      const long long row = row_of(b, k, g);
      const float os = DEQ ? sc[k] : 1.f;
      float amax = lane_amax(buf[k], os);
      for (int o = G >> 1; o > 0; o >>= 1) {
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      }
      if (row >= rows) continue;
      const float scale = quant_scale(amax, qmax);
      const float rcp = __frcp_rn(scale);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int c = v * G + j;
        if (c >= chunks) continue;
        Elements<S, VB> el(buf[k][v]);
        if constexpr (DEQ) {
#pragma unroll
          for (int e = 0; e < E; ++e) el.x[e] = __fmul_rn(el.x[e], os);
        }
        Codes<OB> out;
        if (!fast_codes<DST>(el.x, rcp, out)) out = exact_codes<S, DST, VB>(buf[k][v], os, scale);
        store_codes<OB>(dst + (row * chunks + c) * OB, out);
      }
      if (j == 0) new_scales[row] = scale;
    }
  }
};

template <Src S, int DST, int VB, int V>
__global__ void __launch_bounds__(BLOCK) requant_rows_kernel(Rows<S, DST, VB, V> p,
                                                             long long batches) {
  using R = Rows<S, DST, VB, V>;
  const int j = threadIdx.x & (p.G - 1);
  const int g = threadIdx.x / p.G;
  Raw<VB> cur[R::KMAX][V], nxt[R::KMAX][V];
  float cs[R::KMAX], ns[R::KMAX];
  long long b = blockIdx.x;
  p.load(b, g, j, cur, cs);
  for (; b < batches; b += gridDim.x) {
    const long long next = b + gridDim.x;
    if (next < batches) p.load(next, g, j, nxt, ns);  // in flight while this batch computes
    p.requant(b, g, j, cur, cs);
    if (next >= batches) break;
#pragma unroll
    for (int k = 0; k < R::KMAX; ++k) {
      cs[k] = ns[k];
#pragma unroll
      for (int v = 0; v < V; ++v) cur[k][v] = nxt[k][v];
    }
  }
}

template <Src S, int DST, int VB, int V>
cudaError_t launch_rows(const void* src, const float* old_scales, void* dst, float* new_scales,
                        long long rows, int chunks, int G, cudaStream_t stream) {
  using R = Rows<S, DST, VB, V>;
  constexpr int OUT_ALIGN = R::OB < 16 ? R::OB : 16;
  if (reinterpret_cast<uintptr_t>(src) % VB || reinterpret_cast<uintptr_t>(dst) % OUT_ALIGN) {
    return cudaErrorMisalignedAddress;
  }
  auto kernel = requant_rows_kernel<S, DST, VB, V>;
  static int resident = 0;  // blocks the card holds at once, per instantiation
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                                                BLOCK, 0);
    if (err != cudaSuccess) return err;
    resident = sms * per_sm;
    if (resident <= 0) return cudaErrorInvalidConfiguration;
  }
  R p{static_cast<const uint8_t*>(src), old_scales, static_cast<uint8_t*>(dst), new_scales,
      rows, chunks, G, R::KMAX};
  // Rows a lane holds, K: KMAX, unless fewer cut the rows in series on a
  // lane (rounds of the grid-stride loop times K) by a tenth or more. A
  // small cohort then spreads over more blocks; a large one keeps its loads
  // in flight (at 200 rounds, K = 1 for 1 row in 200 fewer ran 1.3x slower).
  const long long groups = BLOCK / G;
  auto batches_at = [&](int k) { return (rows + groups * k - 1) / (groups * k); };
  auto serial_rows = [&](int k) { return (batches_at(k) + resident - 1) / resident * k; };
  for (int k = R::KMAX >> 1; k >= 1; k >>= 1) {
    if (serial_rows(k) * 10 <= serial_rows(p.K) * 9) p.K = k;
  }
  const long long batches = batches_at(p.K);
  const long long grid = batches < resident ? batches : resident;
  kernel<<<(unsigned)grid, BLOCK, 0, stream>>>(p, batches);
  return cudaGetLastError();
}

template <Src S, int DST, int VB>
cudaError_t by_vectors(int V, const void* src, const float* os, void* dst, float* ns,
                       long long rows, int chunks, int G, cudaStream_t stream) {
  switch (V) {
    case 1: return launch_rows<S, DST, VB, 1>(src, os, dst, ns, rows, chunks, G, stream);
    case 2: return launch_rows<S, DST, VB, 2>(src, os, dst, ns, rows, chunks, G, stream);
    case 4: return launch_rows<S, DST, VB, 4>(src, os, dst, ns, rows, chunks, G, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Requantizes ``rows`` rows of head_dim ``hd`` from format S to DST bits with
// the geometry (vector bytes ``vb``, group lanes ``G``, vectors a lane ``V``)
// that kernels/row_group.py chose; refuses a geometry that does not tile the
// row. ``old_scales`` is read only by the transcode formats.
template <Src S, int DST>
cudaError_t requant_rows(const void* src, const float* old_scales, void* dst, float* new_scales,
                         long long rows, int hd, int vb, int G, int V, cudaStream_t stream) {
  constexpr int PAIR = 2 * src_bits<S>() / 8;  // bytes of an element pair
  const int row_bytes = hd * src_bits<S>() / 8;
  if (hd <= 0 || hd % 2 || vb < PAIR || vb > 16 || (vb & (vb - 1)) || row_bytes % vb ||
      G < 1 || G > 32 || (G & (G - 1))) {
    return cudaErrorInvalidValue;
  }
  const int chunks = row_bytes / vb;
  if ((long long)G * V < chunks) return cudaErrorInvalidValue;
  switch (vb) {
    case 16: return by_vectors<S, DST, 16>(V, src, old_scales, dst, new_scales, rows, chunks, G,
                                           stream);
    case 8:
      if constexpr (PAIR <= 8) {
        return by_vectors<S, DST, 8>(V, src, old_scales, dst, new_scales, rows, chunks, G, stream);
      }
      break;
    case 4:
      if constexpr (PAIR <= 4) {
        return by_vectors<S, DST, 4>(V, src, old_scales, dst, new_scales, rows, chunks, G, stream);
      }
      break;
    case 2:
      if constexpr (PAIR <= 2) {
        return by_vectors<S, DST, 2>(V, src, old_scales, dst, new_scales, rows, chunks, G, stream);
      }
      break;
    case 1:
      if constexpr (PAIR <= 1) {
        return by_vectors<S, DST, 1>(V, src, old_scales, dst, new_scales, rows, chunks, G, stream);
      }
      break;
    default:
      break;
  }
  return cudaErrorInvalidValue;
}

}  // namespace row_group
