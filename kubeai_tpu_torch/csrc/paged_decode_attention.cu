// Dedicated paged-attention kernel for decode (port of the Pallas kernel
// kubeai_tpu/ops/paged_decode_attention.py::_decode_kernel, launched by
// _decode_kernel_call).
//
// The function: paged_attention.cu's for the few queries per slot of a
// decode (S = 1) or speculative verify step (S = G+1, any G): the R = S*G
// query rows of a (slot, KV head), row r = s*G + g at position
// kv_len - S + s, attend causally to the slot's keys through
// page_table[b] over the interleaved
// pool [L*P, page, 2*Kv, D] (K at even heads, V at odd ones; the table
// carries the layer offset; kv_len includes the S new tokens and is
// clamped to the table span); softcap before the mask; f32 accumulation.
//
// Bound on the H100: bytes. Every valid K/V byte is read once (B=8,
// kv_len 512: ~16.8 MB per layer call, ~5 us at 3.35 TB/s); a key of one
// KV head is 512 bytes for 4*D*R <= 64 flops a byte.
//
// The Pallas kernel walks a (KV head, slot)'s pages in order on one core,
// its S*G rows resident. On Hopper that grid, (Kv, B), is 64 blocks at
// B=8 for 132 SMs, so bf16 runs the split-KV body of split_kv_decode.cuh
// (which the ragged kernel's decode regime runs too):
// * split KV: grid (n_splits, Kv, B), each block a piece of its slot's
//   own kv_len, the wrapper choosing n_splits so the card fills
//   (ops/paged_attention.py::split_kv_plan), the partials merged by the
//   last block of each (slot, KV head) in the same launch;
// * copies in flight: a cp.async ring per key stream, the next slices
//   in flight while one is computed;
// * the products on the tensor cores (mma.sync m16n8k16, f32 sums; P as
//   bf16 hi + lo);
// * rows: R <= 16, 32 or 64 take one, two or four m16 row tiles. Each
//   warp holds one tile whatever the count (the warps of a key stream
//   share its K/V slices and split the tiles), so every instance has the
//   one-tile register budget and none spills. More rows (the Pallas
//   kernel takes any S) are cut into groups of group_rows <= 64
//   consecutive rows, each its own set of blocks in the same launch.
//
// float32 keeps the simple CUDA-core kernel below (one block per (KV head,
// slot, row group), f32 shared tiles): its card tests hold it to
// summation order alone, which the tensor cores' reduced-precision
// products would break.
//
// A quantized pool (one byte per element, int8 or fp8 e4m3; the Pallas
// kernel's k_scale / v_scale branch) is read at one byte per element by
// both: the split-KV body stages the bytes and widens them to its bf16
// stage, the float32 kernel widens on load; both fold k_scale into the
// softmax scale and v_scale into the output (attention_common.cuh).
#include "attention_common.cuh"
#include "split_kv_decode.cuh"

using namespace kattn;

constexpr int DNT = 128;  // threads per block of the float32 kernel
constexpr int DKT = 64;   // keys per tile of the float32 kernel

template <int D>
static size_t decode_smem_bytes(int R) {
  return sizeof(long long) * DKT +
         sizeof(float) * ((size_t)R * D + DKT * (D + 1) + DKT * D + (size_t)R * DKT +
                          (size_t)R * D + 3 * R);
}

template <typename T, typename KT, int D>
__global__ void __launch_bounds__(DNT)
paged_decode_kernel(const T* __restrict__ q, const KT* __restrict__ pool,
                    const int* __restrict__ table, const int* __restrict__ kv_lens,
                    T* __restrict__ out, int S, int H, int Kv, int page, int max_pages,
                    int group_rows, float scale, float softcap, float out_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int KST = D + 1, VN = Vec<T>::N, NV = D / VN;
  const int kv = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int G = H / Kv, r0 = blockIdx.z * group_rows, R = min(group_rows, S * G - r0);
  long long* koff = reinterpret_cast<long long*>(smem);
  float* Qs = reinterpret_cast<float*>(koff + DKT);  // [R][D], pre-scaled
  float* Ks = Qs + R * D;                            // [DKT][KST]
  float* Vs = Ks + DKT * KST;                        // [DKT][D]
  float* Ps = Vs + DKT * D;                          // [R][DKT]
  float* acc = Ps + R * DKT;                         // [R][D]
  float* m_s = acc + R * D;
  float* l_s = m_s + R;
  float* a_s = l_s + R;

  const int kvl = max(0, min(kv_lens[b], max_pages * page));  // overrun clamp
  const int* trow = table + (size_t)b * max_pages;
  const long long rs = 2LL * Kv * D;
  const KT* kb = pool + (size_t)2 * kv * D;
  const KT* vb = kb + D;

  // Query row r0 + r = s*G + g is q[b, s, kv*G + g]: the G heads of one
  // token are contiguous, so the rows of one s are one contiguous run.
  for (int idx = tid; idx < R * NV; idx += DNT) {
    const int r = idx / NV, d = (idx % NV) * VN, s = (r0 + r) / G, g = r0 + r - s * G;
    float t[VN];
    Vec<T>::load(q + ((size_t)(b * S + s) * H + kv * G + g) * D + d, t);
#pragma unroll
    for (int i = 0; i < VN; ++i) Qs[r * D + d + i] = t[i] * scale;
  }
  for (int idx = tid; idx < R * D; idx += DNT) acc[idx] = 0.f;
  for (int r = tid; r < R; r += DNT) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }
  __syncthreads();

  // The newest query sits at kvl-1: keys past kvl are never visited.
  for (int k0 = 0; k0 < kvl; k0 += DKT) {
    const int nk = min(DKT, kvl - k0);
    if (tid < DKT) {
      const int kpos = k0 + tid, p = kpos / page;
      koff[tid] = tid < nk ? ((long long)trow[p] * page + (kpos - p * page)) * rs : 0;
    }
    __syncthreads();
    for (int idx = tid; idx < DKT * NV; idx += DNT) {
      const int j = idx / NV, d = (idx % NV) * VN;
      float kt[VN], vt[VN];
      if (j < nk) {
        LoadKV<T, KT>::load(kb + koff[j] + d, kt);
        LoadKV<T, KT>::load(vb + koff[j] + d, vt);
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

    // Scores: query row r sits at kvl - S + (r0 + r)/G; key j at k0 + j.
    for (int idx = tid; idx < R * DKT; idx += DNT) {
      const int r = idx / DKT, j = idx - r * DKT;
      const int qpos = kvl - S + (r0 + r) / G, kpos = k0 + j;
      float s = NEG_INF;
      if (j < nk && kpos <= qpos) {
        float a = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) a += Qs[r * D + d] * Ks[j * KST + d];
        s = softcap > 0.f ? softcap * tanhf(a / softcap) : a;
      }
      Ps[r * DKT + j] = s;
    }
    __syncthreads();

    // Online softmax: one warp per row, two keys per lane.
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < R; r += DNT / 32) {
      const float s0 = Ps[r * DKT + lane], s1 = Ps[r * DKT + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = s0 > NEG_INF / 2 ? expf(s0 - m_new) : 0.f;
      const float p1 = s1 > NEG_INF / 2 ? expf(s1 - m_new) : 0.f;
      Ps[r * DKT + lane] = p0;
      Ps[r * DKT + lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < R * D; idx += DNT) {
      const int r = idx / D, d = idx - r * D;
      float a = acc[idx] * a_s[r];
      for (int j = 0; j < nk; ++j) a += Ps[r * DKT + j] * Vs[j * D + d];
      acc[idx] = a;
    }
    __syncthreads();
  }

  for (int idx = tid; idx < R * D; idx += DNT) {
    const int r = idx / D, d = idx - r * D, s = (r0 + r) / G, g = r0 + r - s * G;
    out[((size_t)(b * S + s) * H + kv * G + g) * D + d] =
        from_float<T>(acc[idx] / fmaxf(l_s[r], 1e-30f) * out_scale);
  }
}

template <typename T, typename KT, int D>
static int launch(const kdec::DecodeArgs& a, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    return kdec::launch_split_kv<D, KT>(a, stream);
  } else {
    // Once per instance, at the per-block limit: the wrapper refuses
    // shapes that need more.
    static const cudaError_t attr = cudaFuncSetAttribute(
        paged_decode_kernel<T, KT, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (attr != cudaSuccess) return (int)attr;
    const int R = a.S * (a.H / a.Kv), RG = a.group_rows;
    if (RG < 1) return (int)cudaErrorInvalidValue;
    dim3 grid(a.Kv, a.B, (R + RG - 1) / RG);
    paged_decode_kernel<T, KT, D><<<grid, DNT, decode_smem_bytes<D>(RG), stream>>>(
        (const T*)a.q, (const KT*)a.pool, a.table, a.kv_lens, (T*)a.out, a.S, a.H, a.Kv,
        a.page, a.max_pages, RG, a.scale * a.k_scale, a.softcap, a.v_scale);
    return (int)cudaGetLastError();
  }
}

template <typename T, typename KT, int D>
static int smem_bytes(int group_rows, int n_splits) {
  if constexpr (sizeof(T) == 4)
    return (int)decode_smem_bytes<D>(group_rows);
  else
    return (int)kdec::split_kv_smem<D, KT>(group_rows, n_splits);
}

// Shared-memory bytes of one block of a launch with group_rows query rows
// per block over a pool of element code kv_code (the wrapper refuses
// shapes above the card's per-block limit).
extern "C" int paged_decode_smem_bytes(int group_rows, int D, int n_splits, int dtype,
                                       int kv_code) {
  KATTN_DISPATCH_KV(smem_bytes, dtype, kv_code, D, group_rows, n_splits);
}

// dtype: 0 = float32, 1 = bfloat16; kv_code: the pool holds the same
// type (0), int8 (1) or fp8 e4m3 (2), dequantized with k_scale / v_scale;
// D: 32, 64 or 128 (a one-byte pool at 32: the KATTN_ONE_BYTE_D32 build;
// bf16 at 256: the KATTN_D256 build).
// The R = S*G rows of a (slot, KV head) go in groups of group_rows
// (1..64) consecutive rows, one set of blocks each. bf16 cuts each slot's
// keys into n_splits (1..64) splits and takes the wrapper's scratch, per
// group of rows: part_o [B*Kv*n_splits*group_rows*D] f32, part_ml
// [B*Kv*n_splits*group_rows] float2, counters [B*Kv] int32 (zero, and
// left zero; the ragged kernel's split-KV regime shares them). Returns a
// cudaError_t (0 = launched).
extern "C" int paged_decode_attention_launch(const void* q, const void* pool,
                                             const void* table, const void* kv_lens,
                                             void* out, void* part_o, void* part_ml,
                                             void* counters, int B, int S, int H, int Kv,
                                             int D, int page, int max_pages, int n_splits,
                                             int group_rows, int dtype, int kv_code,
                                             float scale, float softcap, float k_scale,
                                             float v_scale, void* stream) {
  const kdec::DecodeArgs a{q, pool, (const int*)table, (const int*)kv_lens, out,
                           (float*)part_o, (float2*)part_ml, (int*)counters, B, S, H, Kv,
                           page, max_pages, n_splits, group_rows, scale, softcap, k_scale,
                           v_scale};
  KATTN_DISPATCH_KV(launch, dtype, kv_code, D, a, (cudaStream_t)stream);
}
