// Shared pieces of the port's attention kernels (flash_attention.cu,
// paged_attention.cu, paged_decode_attention.cu).
//
// Conventions shared with the JAX package's Pallas kernels:
//   * masked scores are NEG_INF = -1e30 and only scores > NEG_INF/2 enter
//     the softmax, so a row with no valid key comes out 0, never NaN;
//   * the softmax is online and in float32 (m = running max, l = running
//     denominator, acc = running numerator), and the final division clamps
//     l >= 1e-30;
//   * a softcap (tanh capping) is applied before the mask.
// Element types: float (the card's own f32 checks) and __nv_bfloat16.
//
// KV pool elements (KT) beside the compute type T: T itself, or one byte
// per element, int8_t or __nv_fp8_e4m3 (the JAX package's quantized pool,
// x / scale stored with static per-tensor scales k_scale and v_scale).
// The kernels read those bytes, widen them exactly (every int8 and every
// e4m3 value is a bf16 value) and fold the scales into the arithmetic they
// already do: k_scale into the softmax scale (s = q.k * scale * k_scale),
// v_scale into the output's final rescale (o * v_scale / l). Both folds
// are exact rewrites of (x * scale) . y; the plain version instead
// rounds x * scale to q's dtype first (the JAX CPU twin's recipe).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace kattn {

constexpr float NEG_INF = -1e30f;

// Returns LAUNCH<T, D>(args...) for a runtime (dtype, head dim) pair:
// dtype 0 = float32, 1 = bfloat16; head dims 32, 64 and 128. Head dim 256
// (Gemma's) is bf16 only and lives in a library of its own: the same
// source built with KATTN_D256 holds those instances alone
// (ops/_build.py: the "_d256" libraries, built beside the others, so the
// other models' build time does not grow).
#ifdef KATTN_D256
#define KATTN_DISPATCH(LAUNCH, dtype, D, ...)                                       \
  do {                                                                             \
    if ((dtype) == 1 && (D) == 256) return LAUNCH<__nv_bfloat16, 256>(__VA_ARGS__); \
    return (int)cudaErrorInvalidValue;                                             \
  } while (0)
#else
#define KATTN_DISPATCH(LAUNCH, dtype, D, ...)                                       \
  do {                                                                             \
    if ((dtype) == 1 && (D) == 128) return LAUNCH<__nv_bfloat16, 128>(__VA_ARGS__); \
    if ((dtype) == 1 && (D) == 64) return LAUNCH<__nv_bfloat16, 64>(__VA_ARGS__);   \
    if ((dtype) == 1 && (D) == 32) return LAUNCH<__nv_bfloat16, 32>(__VA_ARGS__);   \
    if ((dtype) == 0 && (D) == 128) return LAUNCH<float, 128>(__VA_ARGS__);         \
    if ((dtype) == 0 && (D) == 64) return LAUNCH<float, 64>(__VA_ARGS__);           \
    if ((dtype) == 0 && (D) == 32) return LAUNCH<float, 32>(__VA_ARGS__);           \
    return (int)cudaErrorInvalidValue;                                             \
  } while (0)
#endif

// Returns LAUNCH<T, KT, D>(args...) for a runtime (dtype, pool element
// code, head dim): dtype as above; kv 0 = the pool holds T (head dims 32,
// 64, 128), 1 = int8 and 2 = fp8 e4m3. The one-byte instances at head
// dims 64 and 128 live in each paged library; those at head dim 32 (the
// JAX package's float32 test configuration) doubled its build time, so a
// second library built from the same source with KATTN_ONE_BYTE_D32
// holds them alone (ops/_build.py: the "_q8d32" libraries, built beside
// the others). The KATTN_D256 library holds bf16 at head dim 256 over
// every pool element type.
#define KATTN_DISPATCH_D(LAUNCH, T, KT, D, ...)                \
  do {                                                         \
    if ((D) == 128) return LAUNCH<T, KT, 128>(__VA_ARGS__);    \
    if ((D) == 64) return LAUNCH<T, KT, 64>(__VA_ARGS__);      \
  } while (0)
#if defined(KATTN_D256)
#define KATTN_DISPATCH_KV_T(LAUNCH, T, kv, D, ...)                                    \
  do {                                                                              \
    if ((kv) == 0 && (D) == 256) return LAUNCH<T, T, 256>(__VA_ARGS__);             \
    if ((kv) == 1 && (D) == 256) return LAUNCH<T, int8_t, 256>(__VA_ARGS__);        \
    if ((kv) == 2 && (D) == 256) return LAUNCH<T, __nv_fp8_e4m3, 256>(__VA_ARGS__); \
  } while (0)
#elif defined(KATTN_ONE_BYTE_D32)
#define KATTN_DISPATCH_KV_T(LAUNCH, T, kv, D, ...)                                   \
  do {                                                                             \
    if ((kv) == 1 && (D) == 32) return LAUNCH<T, int8_t, 32>(__VA_ARGS__);         \
    if ((kv) == 2 && (D) == 32) return LAUNCH<T, __nv_fp8_e4m3, 32>(__VA_ARGS__);  \
  } while (0)
#else
#define KATTN_DISPATCH_KV_T(LAUNCH, T, kv, D, ...)                                   \
  do {                                                                             \
    if ((kv) == 0 && (D) == 32) return LAUNCH<T, T, 32>(__VA_ARGS__);              \
    if ((kv) == 0) KATTN_DISPATCH_D(LAUNCH, T, T, D, __VA_ARGS__);                 \
    if ((kv) == 1) KATTN_DISPATCH_D(LAUNCH, T, int8_t, D, __VA_ARGS__);            \
    if ((kv) == 2) KATTN_DISPATCH_D(LAUNCH, T, __nv_fp8_e4m3, D, __VA_ARGS__);     \
  } while (0)
#endif
#ifdef KATTN_D256
#define KATTN_DISPATCH_KV(LAUNCH, dtype, kv, D, ...)                                  \
  do {                                                                              \
    if ((dtype) == 1) KATTN_DISPATCH_KV_T(LAUNCH, __nv_bfloat16, kv, D, __VA_ARGS__); \
    return (int)cudaErrorInvalidValue;                                              \
  } while (0)
#else
#define KATTN_DISPATCH_KV(LAUNCH, dtype, kv, D, ...)                                  \
  do {                                                                              \
    if ((dtype) == 1) KATTN_DISPATCH_KV_T(LAUNCH, __nv_bfloat16, kv, D, __VA_ARGS__); \
    if ((dtype) == 0) KATTN_DISPATCH_KV_T(LAUNCH, float, kv, D, __VA_ARGS__);         \
    return (int)cudaErrorInvalidValue;                                              \
  } while (0)
#endif

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// (x0, x1) as a bf16 pair `hi` plus the pair of what it rounded off, `lo`
// (element 0 in the low half, as an mma A fragment wants it). P enters
// P V as hi + lo: a single bf16 P costs 2^-9 per weight, which breaks the
// one-rounding tolerance of the card tests.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// ---------------------------------------------------------------------------
// One-byte pool elements, widened exactly.

// Byte J of w, an int8 biased to unsigned by the caller (w ^ 0x80808080),
// as a float: the byte is spliced under the exponent of 2^23 (one PRMT)
// and one FADD removes 2^23 + 128 (no conversion unit; exact).
template <int J>
__device__ __forceinline__ float i8f(uint32_t w) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650 + J)) - 8388736.f;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The two e4m3 values of the low 16 bits of w as floats (the hardware's
// e4m3x2 -> f16x2 conversion, exact; NaN stays NaN).
__device__ __forceinline__ float2 e4m3x2_f2(uint32_t w) {
  uint32_t h;
  const unsigned short v = (unsigned short)(w & 0xFFFFu);
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;" : "=r"(h) : "h"(v));
  return __half22float2(*reinterpret_cast<const __half2*>(&h));
}

// Eight one-byte elements (two words, element 0 in the low byte) as eight
// bf16 (four words, element 0 in the low half): exact.
template <typename KT>
__device__ __forceinline__ uint4 widen8_bf16(uint2 in);
template <>
__device__ __forceinline__ uint4 widen8_bf16<int8_t>(uint2 in) {
  const uint32_t a = in.x ^ 0x80808080u, b = in.y ^ 0x80808080u;
  return make_uint4(pack_bf16(i8f<0>(a), i8f<1>(a)), pack_bf16(i8f<2>(a), i8f<3>(a)),
                    pack_bf16(i8f<0>(b), i8f<1>(b)), pack_bf16(i8f<2>(b), i8f<3>(b)));
}
template <>
__device__ __forceinline__ uint4 widen8_bf16<__nv_fp8_e4m3>(uint2 in) {
  const float2 f0 = e4m3x2_f2(in.x), f1 = e4m3x2_f2(in.x >> 16);
  const float2 f2 = e4m3x2_f2(in.y), f3 = e4m3x2_f2(in.y >> 16);
  return make_uint4(pack_bf16(f0.x, f0.y), pack_bf16(f1.x, f1.y), pack_bf16(f2.x, f2.y),
                    pack_bf16(f3.x, f3.y));
}

// Four one-byte elements (one word) as floats.
template <typename KT>
__device__ __forceinline__ void widen4_f32(uint32_t w, float* dst);
template <>
__device__ __forceinline__ void widen4_f32<int8_t>(uint32_t w, float* dst) {
  const uint32_t a = w ^ 0x80808080u;
  dst[0] = i8f<0>(a); dst[1] = i8f<1>(a); dst[2] = i8f<2>(a); dst[3] = i8f<3>(a);
}
template <>
__device__ __forceinline__ void widen4_f32<__nv_fp8_e4m3>(uint32_t w, float* dst) {
  const float2 lo = e4m3x2_f2(w), hi = e4m3x2_f2(w >> 16);
  dst[0] = lo.x; dst[1] = lo.y; dst[2] = hi.x; dst[3] = hi.y;
}

// One 16-byte load of VEC<T> consecutive elements, widened to float.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* src, float* dst) {
    float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* src, float* dst) {
    uint4 u = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      dst[2 * i] = f.x;
      dst[2 * i + 1] = f.y;
    }
  }
};

// Vec<T>::N consecutive pool elements of type KT, widened to float: one
// 16-byte load when the pool holds T, one 4- or 8-byte load when it holds
// one byte per element.
template <typename T, typename KT>
struct LoadKV {
  static constexpr int N = Vec<T>::N;
  __device__ __forceinline__ static void load(const KT* src, float* dst) {
    if constexpr (sizeof(KT) == sizeof(T)) {
      Vec<T>::load(reinterpret_cast<const T*>(src), dst);
    } else if constexpr (N == 4) {
      widen4_f32<KT>(*reinterpret_cast<const uint32_t*>(src), dst);
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(src);
      widen4_f32<KT>(u.x, dst);
      widen4_f32<KT>(u.y, dst + 4);
    }
  }
};

// ---------------------------------------------------------------------------
// Tile core of the flash and paged-prefill kernels.
//
// One block of NT threads owns BQ query ROWS of one (batch b, KV head kv):
// row r = s*G + g is query s of query head kv*G + g, so the G heads that
// share a KV head read each K/V tile once. The block walks key tiles of BK
// consecutive positions up to the newest query of the tile; each key's
// K/V row is found through Src::key_off (contiguous for flash, through the
// page table for paged attention; KT is the pool's element type, widened
// on load). Query s sits at absolute position qoff + s and sees keys
// kpos <= qoff + s with kpos < klimit. The output is acc / l * out_scale
// (a quantized pool's v_scale; 1 otherwise).
constexpr int BQ = 64;
constexpr int BK = 32;
constexpr int NT = 256;

template <int D>
constexpr size_t tile_smem_bytes() {
  return sizeof(long long) * BK +
         sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1) + 3 * BQ);
}

template <typename T>
struct ContigSrc {  // k, v: [B, S, Kv, D]; bases already at (b, 0, kv)
  const T* k;
  const T* v;
  long long row_stride;  // Kv * D
  __device__ __forceinline__ long long key_off(int kpos) const {
    return (long long)kpos * row_stride;
  }
};

template <typename T>
struct PagedSrc {  // pool: [L*P, page, 2*Kv, D]; bases at head 2kv (K), 2kv+1 (V)
  const T* k;
  const T* v;
  const int* table_row;  // this slot's page-table row, layer offset included
  int page;
  long long row_stride;  // 2 * Kv * D
  __device__ __forceinline__ long long key_off(int kpos) const {
    int p = kpos / page;
    return ((long long)table_row[p] * page + (kpos - p * page)) * row_stride;
  }
};

template <typename T, int D, typename KT = T, typename Src>
__device__ __forceinline__ void tile_attention(
    const T* __restrict__ q, T* __restrict__ out, const Src& src,
    int S, int H, int G, int b, int kv, int tile, int qoff, int klimit,
    float scale, float softcap, unsigned char* smem_raw, float out_scale = 1.f) {
  constexpr int QST = D + 1, KST = D + 1, SST = BK + 1;
  constexpr int VN = Vec<T>::N, NV = D / VN, NC = D / 16;
  long long* koff = reinterpret_cast<long long*>(smem_raw);
  float* Qs = reinterpret_cast<float*>(koff + BK);  // [BQ][QST], pre-scaled
  float* Ks = Qs + BQ * QST;                        // [BK][KST]
  float* Vs = Ks + BK * KST;                        // [BK][D]
  float* Ss = Vs + BK * D;                          // [BQ][SST] scores, then p
  float* m_s = Ss + BQ * SST;
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;

  const int tid = threadIdx.x;
  const int r0 = tile * BQ;
  const int rows = min(BQ, S * G - r0);

  for (int idx = tid; idx < BQ * NV; idx += NT) {
    const int r = idx / NV, d = (idx % NV) * VN;
    float t[VN];
    if (r < rows) {
      const int rg = r0 + r, s = rg / G, g = rg - s * G;
      Vec<T>::load(q + ((size_t)(b * S + s) * H + kv * G + g) * D + d, t);
    } else {
#pragma unroll
      for (int i = 0; i < VN; ++i) t[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VN; ++i) Qs[r * QST + d + i] = t[i] * scale;
  }
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  const int ty = tid / 16, tx = tid % 16;  // rows ty + 16i, score cols tx + 16j
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  const int s_last = (r0 + rows - 1) / G;
  const int n_keys = max(0, min(klimit, qoff + s_last + 1));
  const bool full = rows == BQ;
  __syncthreads();

  for (int k0 = 0; k0 < n_keys; k0 += BK) {
    const int nk = min(BK, n_keys - k0);
    if (tid < BK) koff[tid] = tid < nk ? src.key_off(k0 + tid) : 0;
    __syncthreads();
    for (int idx = tid; idx < BK * NV; idx += NT) {
      const int j = idx / NV, d = (idx % NV) * VN;
      float kt[VN], vt[VN];
      if (j < nk) {
        LoadKV<T, KT>::load(src.k + koff[j] + d, kt);
        LoadKV<T, KT>::load(src.v + koff[j] + d, vt);
      } else {
#pragma unroll
        for (int i = 0; i < VN; ++i) kt[i] = vt[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < VN; ++i) {
        Ks[j * KST + d + i] = kt[i];
        Vs[j * D + d + i] = vt[i];
      }
    }
    __syncthreads();

    // Scores S = (scale q) k^T for 4 rows x 2 keys per thread.
    float sc[4][2];
    if (full) {
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[i][0] = sc[i][1] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float k0v = Ks[tx * KST + d], k1v = Ks[(tx + 16) * KST + d];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float qv = Qs[(ty + 16 * i) * QST + d];
          sc[i][0] += qv * k0v;
          sc[i][1] += qv * k1v;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sc[i][0] = sc[i][1] = 0.f;
        if (ty + 16 * i < rows) {
          for (int d = 0; d < D; ++d) {
            const float qv = Qs[(ty + 16 * i) * QST + d];
            sc[i][0] += qv * Ks[tx * KST + d];
            sc[i][1] += qv * Ks[(tx + 16) * KST + d];
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qpos = qoff + (r0 + r) / G;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = tx + 16 * jj;
        float s = sc[i][jj];
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        const int kpos = k0 + j;
        Ss[r * SST + j] = (r < rows && j < nk && kpos <= qpos) ? s : NEG_INF;
      }
    }
    __syncthreads();

    // Online softmax: 4 neighbouring threads per row, 8 keys each.
    {
      const int r = tid / 4, part = tid % 4;
      float sv[8];
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        sv[c] = Ss[r * SST + part * 8 + c];
        mx = fmaxf(mx, sv[c]);
      }
      const float m_old = m_s[r];
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float p = sv[c] > NEG_INF / 2 ? expf(sv[c] - m_new) : 0.f;
        Ss[r * SST + part * 8 + c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_old - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = alpha * acc + p V, 4 rows x NC dims per thread.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    if (full) {
      for (int kk = 0; kk < nk; ++kk) {
        float p[4], vv[NC];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = Ss[(ty + 16 * i) * SST + kk];
#pragma unroll
        for (int c = 0; c < NC; ++c) vv[c] = Vs[kk * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[i][c] += p[i] * vv[c];
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (ty + 16 * i < rows) {
          for (int kk = 0; kk < nk; ++kk) {
            const float p = Ss[(ty + 16 * i) * SST + kk];
#pragma unroll
            for (int c = 0; c < NC; ++c) acc[i][c] += p * Vs[kk * D + tx + 16 * c];
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r < rows) {
      const int rg = r0 + r, s = rg / G, g = rg - s * G;
      const float l = fmaxf(l_s[r], 1e-30f);
      T* o = out + ((size_t)(b * S + s) * H + kv * G + g) * D;
#pragma unroll
      for (int c = 0; c < NC; ++c) o[tx + 16 * c] = from_float<T>(acc[i][c] / l * out_scale);
    }
  }
}

}  // namespace kattn
