// Dedicated paged-attention kernel for decode (port of the Pallas kernel
// kubeai_tpu/ops/paged_decode_attention.py::_decode_kernel).
//
// Same function as paged_attention.cu restricted to S <= 8 queries per
// slot (decode, or speculative G+1). Bound on the H100: memory — every
// valid K/V byte of the slot is read once (B=8, kv_len=512: ~16.8 MB per
// layer call, ~5 us at 3.35 TB/s); the arithmetic is a few FLOP per byte.
// Design: one block per (KV head, slot) keeps the slot's R = S*G query
// rows (its S tokens x the G query heads sharing the KV head) resident in
// shared memory for the whole walk, so each page is read once for all G
// heads; the block walks page_table[b] in 64-key tiles with 16-byte
// loads and stops at kv_len. Threads are spread over keys (scores) and
// over output elements (p V), not over query rows, because R is small.
// Not yet done: splitting a long walk over several blocks (flash-decoding)
// to fill the card at small B*Kv.
#include "attention_common.cuh"

using namespace kattn;

constexpr int DNT = 128;  // threads per block
constexpr int DKT = 64;   // keys per tile

template <int D>
static size_t decode_smem_bytes(int R) {
  return sizeof(long long) * DKT +
         sizeof(float) * ((size_t)R * D + DKT * (D + 1) + DKT * D + (size_t)R * DKT +
                          (size_t)R * D + 3 * R);
}

template <typename T, int D>
__global__ void __launch_bounds__(DNT)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ pool,
                    const int* __restrict__ table, const int* __restrict__ kv_lens,
                    T* __restrict__ out, int S, int H, int Kv, int page, int max_pages,
                    float scale, float softcap) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int KST = D + 1, VN = Vec<T>::N, NV = D / VN;
  const int kv = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int G = H / Kv, R = S * G;
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
  const T* kb = pool + (size_t)2 * kv * D;
  const T* vb = kb + D;

  // Query row r = s*G + g is q[b, s, kv*G + g]: the G heads of one token
  // are contiguous, so the rows of one s are one contiguous run.
  for (int idx = tid; idx < R * NV; idx += DNT) {
    const int r = idx / NV, d = (idx % NV) * VN, s = r / G, g = r - s * G;
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
        Vec<T>::load(kb + koff[j] + d, kt);
        Vec<T>::load(vb + koff[j] + d, vt);
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

    // Scores: query row r sits at kvl - S + r/G; key j at k0 + j.
    for (int idx = tid; idx < R * DKT; idx += DNT) {
      const int r = idx / DKT, j = idx - r * DKT;
      const int qpos = kvl - S + r / G, kpos = k0 + j;
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
    const int r = idx / D, d = idx - r * D, s = r / G, g = r - s * G;
    out[((size_t)(b * S + s) * H + kv * G + g) * D + d] =
        from_float<T>(acc[idx] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename T, int D>
static int launch(const void* q, const void* pool, const int* table, const int* kv_lens,
                  void* out, int B, int S, int H, int Kv, int page, int max_pages,
                  float scale, float softcap, cudaStream_t stream) {
  const size_t smem = decode_smem_bytes<D>(S * (H / Kv));
  cudaError_t e = cudaFuncSetAttribute(paged_decode_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(Kv, B);
  paged_decode_kernel<T, D><<<grid, DNT, smem, stream>>>(
      (const T*)q, (const T*)pool, table, kv_lens, (T*)out, S, H, Kv, page, max_pages,
      scale, softcap);
  return (int)cudaGetLastError();
}

// Shared-memory bytes a launch with R = S*G query rows needs (the wrapper
// refuses shapes above the card's per-block limit).
extern "C" int paged_decode_smem_bytes(int R, int D) {
  if (D == 128) return (int)decode_smem_bytes<128>(R);
  if (D == 64) return (int)decode_smem_bytes<64>(R);
  return (int)decode_smem_bytes<32>(R);
}

// dtype: 0 = float32, 1 = bfloat16; D: 32, 64 or 128. Returns a
// cudaError_t (0 = launched).
extern "C" int paged_decode_attention_launch(const void* q, const void* pool,
                                             const void* table, const void* kv_lens,
                                             void* out, int B, int S, int H, int Kv,
                                             int D, int page, int max_pages, int dtype,
                                             float scale, float softcap, void* stream) {
  KATTN_DISPATCH(launch, dtype, D, q, pool, (const int*)table, (const int*)kv_lens, out, B,
                 S, H, Kv, page, max_pages, scale, softcap, (cudaStream_t)stream);
}
