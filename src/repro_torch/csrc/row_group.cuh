// Row-group step of the KV-page kernels, for sm_90a. Requantization:
// quant_page.cu (f32/bf16 rows -> int8/int4), transcode_page.cu (int8 <->
// int4 rows, dequantized with their old scale first) and cxl_line.cu's
// encode (f32/bf16 rows -> int8, plus the stored width of each 64-code
// hardware line: LINES). Dequantization: dequant_page.cu (int8/int4 rows ->
// f32/bf16) and cxl_line.cu's decode (int8 -> f32). One kernel template over
// both steps (rows_kernel), one instantiation per (step, formats, vector
// width, vectors per lane).
//
// A row is one (page, token, kv-head) vector of head_dim values; its bytes
// are cut into C chunks of VB bytes (VB = 16 where the row allows it, else
// the largest of 8, 4, 2, 1 bytes that divides the row and holds whole
// element pairs). A ROW GROUP of G lanes (G = C rounded up to a power of two,
// at most 32) holds the row: lane j loads chunks j + G v, v < V, one vector
// load each, so neighbouring lanes read neighbouring bytes and a warp reads
// 32 / G rows at once. The row's absmax is a __shfl_xor_sync max over
// log2(G) steps inside the group. The geometry is chosen in Python
// (kernels/row_group.py) from (head_dim, source format, output format)
// alone; the pointers must be aligned to it, and the launcher refuses those
// that are not (no narrower path is taken at run time).
//
// Rows in flight: a lane holds up to K = 4 / V rows of a batch in registers
// and, in a grid-stride loop over batches, issues the NEXT batch's vector
// loads (and scales) before it computes the current one
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
//
// Line widths (Rows<..., LINES>, the cxl encode): a 64-code line is 128 B of
// bf16 or 256 B of f32 source, LINE_LANES = 8 or 16 consecutive lanes of one
// vector slot. Each lane takes its vector's max |code| from the codes it
// stores (|t - 1.5 * 2^23| on the fast path, the bytes exact_codes gave
// otherwise), a segmented shuffle over log2(LINE_LANES) steps gives the
// line's, and the segment's first lane stores 4 (<= 7) or 8. A full-mask
// shuffle must be reached by every lane of the warp, so with LINES no lane
// skips the codes: a lane past the rows (the last batch's tail groups) or
// past the chunks (hd 192 at bf16: 24 chunks on G = 32) computes codes of
// the zeros its buffers hold, and only its stores are skipped. Payload and
// scales are those of quant_pages(., 8) by construction.
//
// Dequantization (DequantRows; dequant_page.cu, cxl_line.cu's decode): the
// same loads, rows in flight and grid; each code becomes its exact float
// (Elements) times the row's scale by __fmul_rn, f32 or
// __floats2bfloat162_rn, so the output is the plain version's q.float() *
// scale (.to(bf16)) bit for bit. No shuffle. Bound: bytes, mostly stores
// (int4 -> f32 writes 8x what it reads), so its vectors are cut by the
// output: a lane's source vector is the codes of 16 output bytes (2 B of int4
// -> f32 up to 8 B of int8 -> bf16), and the lanes of a group store
// neighbouring 16-byte vectors.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

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
// (NaN fails the test), for exact_codes to redo the vector. CMAX: cmax gets
// the vector's max |code|, |t - 1.5 * 2^23| (exact), for the line widths.
template <int DST, int E, int OB, bool CMAX>
__device__ __forceinline__ bool fast_codes(const float (&x)[E], float rcp, Codes<OB>& out,
                                           float& cmax) {
  bool ok = true;
  uint32_t t[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float y = __fmul_rn(x[e], rcp);
    const float tf = __fadd_rn(y, RINT_MAGIC);
    const float code = __fsub_rn(tf, RINT_MAGIC);
    ok &= fabsf(__fsub_rn(y, code)) < TIE_GUARD;
    if constexpr (CMAX) cmax = fmaxf(cmax, fabsf(code));
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

// The largest |code| of a vector of int8 codes (exact_codes' output, for the
// line widths of the cxl encode; out of the fast path).
template <int OB>
__device__ __forceinline__ float code_amax(const Codes<OB>& c) {
  static_assert(OB % 4 == 0, "whole words of int8 codes");
  int m = 0;
#pragma unroll
  for (int i = 0; i < OB / 4; ++i) {
#pragma unroll
    for (int byte = 0; byte < 4; ++byte) m = max(m, abs((int)(int8_t)(c.w[i] >> (8 * byte))));
  }
  return (float)m;
}

// E dequantized values x[e] * s (IEEE multiply) stored as f32, or as bf16
// by __floats2bfloat162_rn (round to nearest even, as the plain version's
// cast), with the widest aligned stores (16 bytes where they fit).
template <bool BF16, int E>
__device__ __forceinline__ void store_values(uint8_t* __restrict__ p, const float (&x)[E],
                                             float s) {
  constexpr int W = BF16 ? E / 2 : E;  // 32-bit words
  uint32_t w[W];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if constexpr (BF16) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(__fmul_rn(x[2 * i], s),
                                                     __fmul_rn(x[2 * i + 1], s));
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    } else {
      w[i] = __float_as_uint(__fmul_rn(x[i], s));
    }
  }
  if constexpr (W >= 4) {
#pragma unroll
    for (int i = 0; i < W; i += 4) {
      reinterpret_cast<uint4*>(p)[i / 4] = make_uint4(w[i], w[i + 1], w[i + 2], w[i + 3]);
    }
  } else if constexpr (W == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
    *reinterpret_cast<unsigned int*>(p) = w[0];
  }
}

// The rows of a launch and the loads both steps share: rows of format S cut
// into chunks of VB bytes, lane j of group g holding chunks j + G v (v < V)
// of up to K <= KMAX rows a batch, with each row's scale where S is a code
// format (the transcode's old scales, the dequant's scales).
template <Src S, int VB, int V>
struct Batches {
  static constexpr bool CODES = S == Src::I8 || S == Src::I4;
  static constexpr int E = VB * 8 / src_bits<S>();  // elements a vector holds
  static constexpr int KMAX = 4 / V;                 // rows a lane holds
  static constexpr int VBYTES = VB, VECS = V;

  const uint8_t* src;  // read through __ldg
  const float* src_scales;
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
      if constexpr (CODES) sc[k] = ok ? __ldg(src_scales + row) : 0.f;
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
};

template <bool LINES>
struct LineOut {};  // no line widths

template <>
struct LineOut<true> {
  int* line_bits;  // [rows, hd / 64] int32: 4 or 8
};

// The requantization step (quant, transcode, cxl encode). LINES adds the
// cxl_hw line widths: a 64-code line is LINE_LANES consecutive lanes of one
// vector slot (8 at bf16, 16 at f32; kernels/row_group.py's line_geometry),
// its max |code| a segmented __shfl_xor_sync max over log2(LINE_LANES)
// steps, stored by the segment's first lane: 4 if <= 7, else 8.
template <Src S, int DST, int VB, int V, bool LINES = false>
struct Rows : Batches<S, VB, V>, LineOut<LINES> {
  using B = Batches<S, VB, V>;
  static constexpr int E = B::E, KMAX = B::KMAX;
  static constexpr bool DEQ = B::CODES;  // transcode
  static constexpr int OB = E * DST / 8;  // code bytes of a vector
  static constexpr int LINE_LANES = 64 * src_bits<S>() / 8 / VB;
  static_assert(!LINES || (DST == 8 && VB == 16 && (S == Src::F32 || S == Src::BF16)),
                "line widths: int8 codes of f32/bf16 rows in 16-byte vectors");

  uint8_t* dst;
  float* new_scales;

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

  __device__ __forceinline__ void run(long long b, int g, int j, const Raw<VB> (&buf)[KMAX][V],
                                      const float (&sc)[KMAX]) const {
    const float qmax = DST == 8 ? 127.f : 7.f;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k >= this->K) break;  // block-uniform: every lane of the warp shuffles alike
      const long long row = this->row_of(b, k, g);
      const float os = DEQ ? sc[k] : 1.f;
      float amax = lane_amax(buf[k], os);
      for (int o = this->G >> 1; o > 0; o >>= 1) {
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      }
      // The line shuffle needs every lane of the warp: with LINES a lane past
      // the rows or the chunks computes the codes of its zero buffers (scale
      // 1 where the whole group is past the rows) and stores nothing.
      if constexpr (!LINES) {
        if (row >= this->rows) continue;
      }
      const bool live = !LINES || row < this->rows;
      const float scale = quant_scale(amax, qmax);
      const float rcp = __frcp_rn(scale);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int c = v * this->G + j;
        if constexpr (!LINES) {
          if (c >= this->chunks) continue;
        }
        const bool keep = !LINES || (live && c < this->chunks);
        Elements<S, VB> el(buf[k][v]);
        if constexpr (DEQ) {
#pragma unroll
          for (int e = 0; e < E; ++e) el.x[e] = __fmul_rn(el.x[e], os);
        }
        Codes<OB> out;
        float cmax = 0.f;
        if (!fast_codes<DST, E, OB, LINES>(el.x, rcp, out, cmax)) {
          out = exact_codes<S, DST, VB>(buf[k][v], os, scale);
          if constexpr (LINES) cmax = code_amax(out);
        }
        if (keep) store_codes<OB>(dst + (row * this->chunks + c) * OB, out);
        if constexpr (LINES) {
#pragma unroll
          for (int o = LINE_LANES >> 1; o > 0; o >>= 1) {
            cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, o));
          }
          if (keep && (j & (LINE_LANES - 1)) == 0) {
            this->line_bits[row * (this->chunks / LINE_LANES) + c / LINE_LANES] =
                cmax <= 7.f ? 4 : 8;
          }
        }
      }
      if (j == 0 && live) new_scales[row] = scale;
    }
  }
};

// The dequantization step: int8/int4 codes to exact floats (Elements: PRMT
// + FSUB, no I2F), times the row's scale (one load a lane, with the row's
// codes) by __fmul_rn, stored as f32 or bf16. No shuffle: a lane past the
// rows or the chunks skips its vectors.
template <Src S, bool BF16, int VB, int V>
struct DequantRows : Batches<S, VB, V> {
  using B = Batches<S, VB, V>;
  static constexpr int E = B::E, KMAX = B::KMAX;
  static constexpr int OB = E * (BF16 ? 2 : 4);  // output bytes of a vector
  static_assert(B::CODES, "dequant reads int8 or int4 codes");

  uint8_t* out;

  __device__ __forceinline__ void run(long long b, int g, int j, const Raw<VB> (&buf)[KMAX][V],
                                      const float (&sc)[KMAX]) const {
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k >= this->K) break;
      const long long row = this->row_of(b, k, g);
      if (row >= this->rows) continue;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int c = v * this->G + j;
        if (c >= this->chunks) continue;
        const Elements<S, VB> el(buf[k][v]);
        store_values<BF16>(out + (row * this->chunks + c) * OB, el.x, sc[k]);
      }
    }
  }
};

// Either step over its rows: a grid-stride loop over batches of rows, the
// NEXT batch's vector loads (and scales) issued before the current batch
// computes (a register double buffer).
template <class R>
__global__ void __launch_bounds__(BLOCK) rows_kernel(R p, long long batches) {
  constexpr int KMAX = R::KMAX, V = R::VECS, VB = R::VBYTES;
  const int j = threadIdx.x & (p.G - 1);
  const int g = threadIdx.x / p.G;
  Raw<VB> cur[KMAX][V], nxt[KMAX][V];
  float cs[KMAX], ns[KMAX];
  long long b = blockIdx.x;
  p.load(b, g, j, cur, cs);
  for (; b < batches; b += gridDim.x) {
    const long long next = b + gridDim.x;
    if (next < batches) p.load(next, g, j, nxt, ns);  // in flight while this batch computes
    p.run(b, g, j, cur, cs);
    if (next >= batches) break;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      cs[k] = ns[k];
#pragma unroll
      for (int v = 0; v < V; ++v) cur[k][v] = nxt[k][v];
    }
  }
}

// Launches rows_kernel<R> on the card's resident block count
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs), capped by the work.
// p's rows, chunks and G are set; K is chosen here.
template <class R>
cudaError_t launch_rows(R p, cudaStream_t stream) {
  auto kernel = rows_kernel<R>;
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
  // Rows a lane holds, K: KMAX, unless fewer cut the rows in series on a
  // lane (rounds of the grid-stride loop times K) by a tenth or more. A
  // small cohort then spreads over more blocks; a large one keeps its loads
  // in flight (at 200 rounds, K = 1 for 1 row in 200 fewer ran 1.3x slower).
  p.K = R::KMAX;
  const long long rows = p.rows, groups = BLOCK / p.G;
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

// Calls f(vb, V) with both as std::integral_constant for a geometry that
// tiles a row of hd elements of format S; cudaErrorInvalidValue for one that
// does not (kernels/row_group.py chooses it: vector bytes vb, group lanes G,
// vectors a lane V).
template <Src S, class F>
cudaError_t by_geometry(int hd, int vb, int G, int V, int* chunks, F&& f) {
  constexpr int PAIR = 2 * src_bits<S>() / 8;  // bytes of an element pair
  const int row_bytes = hd * src_bits<S>() / 8;
  if (hd <= 0 || hd % 2 || vb < PAIR || vb > 16 || (vb & (vb - 1)) || row_bytes % vb ||
      G < 1 || G > 32 || (G & (G - 1))) {
    return cudaErrorInvalidValue;
  }
  *chunks = row_bytes / vb;
  if ((long long)G * V < *chunks) return cudaErrorInvalidValue;
  auto vectors = [&](auto vbc) -> cudaError_t {
    switch (V) {
      case 1: return f(vbc, std::integral_constant<int, 1>{});
      case 2: return f(vbc, std::integral_constant<int, 2>{});
      case 4: return f(vbc, std::integral_constant<int, 4>{});
      default: return cudaErrorInvalidValue;
    }
  };
  switch (vb) {
    case 16: return vectors(std::integral_constant<int, 16>{});
    case 8:
      if constexpr (PAIR <= 8) return vectors(std::integral_constant<int, 8>{});
      break;
    case 4:
      if constexpr (PAIR <= 4) return vectors(std::integral_constant<int, 4>{});
      break;
    case 2:
      if constexpr (PAIR <= 2) return vectors(std::integral_constant<int, 2>{});
      break;
    case 1:
      if constexpr (PAIR <= 1) return vectors(std::integral_constant<int, 1>{});
      break;
    default:
      break;
  }
  return cudaErrorInvalidValue;
}

inline bool misaligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % (bytes < 16 ? bytes : 16) != 0;
}

// Requantizes ``rows`` rows of head_dim ``hd`` from format S to DST bits with
// the geometry (vb, G, V) that kernels/row_group.py chose. ``old_scales`` is
// read only by the transcode formats; ``line_bits`` (LINES: the cxl encode,
// 16-byte vectors, hd a multiple of 64) receives each line's stored width.
template <Src S, int DST, bool LINES = false>
cudaError_t requant_rows(const void* src, const float* old_scales, void* dst, float* new_scales,
                         long long rows, int hd, int vb, int G, int V, cudaStream_t stream,
                         int* line_bits = nullptr) {
  int chunks = 0;
  return by_geometry<S>(hd, vb, G, V, &chunks, [&](auto vbc, auto vc) -> cudaError_t {
    constexpr int VB = decltype(vbc)::value, VV = decltype(vc)::value;
    if constexpr (LINES && VB != 16) {
      return cudaErrorInvalidValue;
    } else {
      using R = Rows<S, DST, VB, VV, LINES>;
      if (misaligned(src, VB) || misaligned(dst, R::OB)) return cudaErrorMisalignedAddress;
      R p{};
      if constexpr (LINES) {
        if (chunks % R::LINE_LANES || G < R::LINE_LANES) return cudaErrorInvalidValue;
        p.line_bits = line_bits;
      }
      p.src = static_cast<const uint8_t*>(src);
      p.src_scales = old_scales;
      p.rows = rows;
      p.chunks = chunks;
      p.G = G;
      p.dst = static_cast<uint8_t*>(dst);
      p.new_scales = new_scales;
      return launch_rows(p, stream);
    }
  });
}

// Dequantizes ``rows`` rows of hd int8 (S = I8) or packed int4 (I4) codes to
// f32, or bf16 (BF16), with the geometry (vb, G, V) of
// kernels/row_group.py's dequant_geometry.
template <Src S, bool BF16>
cudaError_t dequant_rows(const void* src, const float* scales, void* out, long long rows, int hd,
                         int vb, int G, int V, cudaStream_t stream) {
  int chunks = 0;
  return by_geometry<S>(hd, vb, G, V, &chunks, [&](auto vbc, auto vc) -> cudaError_t {
    using R = DequantRows<S, BF16, decltype(vbc)::value, decltype(vc)::value>;
    if (misaligned(src, R::VBYTES) || misaligned(out, R::OB)) return cudaErrorMisalignedAddress;
    R p{};
    p.src = static_cast<const uint8_t*>(src);
    p.src_scales = scales;
    p.rows = rows;
    p.chunks = chunks;
    p.G = G;
    p.out = static_cast<uint8_t*>(out);
    return launch_rows(p, stream);
  });
}

}  // namespace row_group
