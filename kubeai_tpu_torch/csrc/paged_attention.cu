// Paged attention over the interleaved KV pool (port of the library
// Pallas kernel jax.experimental.pallas.ops.tpu.ragged_paged_attention,
// which kubeai_tpu/ops/paged_attention.py::paged_attention_ragged calls).
//
// Every slot b holds S queries (the engine's uniform split) at absolute
// positions kv_len-S .. kv_len-1; they attend causally to the slot's keys,
// found by walking page_table[b] over the pool [L*P, page, 2*Kv, D] (K at
// head 2kv, V at 2kv+1; the table already carries the layer's l*P
// offset). kv_len is clamped to the table span (a finished slot's decode
// overrun). Optional softcap, applied before the mask.
//
// Two regimes for bf16, chosen from the rows per (slot, KV head), S*G:
//
// * Prefill (S*G >= 64: cold buckets, chunks). Bound: the tensor-core rate
//   for 1024-token chunks. The Hopper tile of hopper_attention.cuh (wgmma
//   products, TMA-fed 2-stage ring) with keys found through the page
//   table: a key tile is 64 rows, one TMA box over the pool viewed as
//   [L*P*page, 2*Kv, D] per page (several boxes when pages are smaller
//   than a tile), so the table is read once per box, not once per key.
//
// * Decode (S*G <= 16: one token per slot, or up to 4 at G = 4). Bound:
//   memory, every valid K/V byte once (B=8, kv_len 512: ~16.8 MB per
//   layer call, ~5 us at 3.35 TB/s). Split KV (flash-decoding): block
//   (split, kv, b) takes the split-th of n_splits pieces of the slot's
//   kv_len, keeps the slot's query rows resident and streams its keys
//   with cp.async, products on the tensor cores (mma.sync), and, when the
//   slot's keys span several splits, writes a partial (m, l, acc) to an
//   f32 scratch. The last block of a (slot, KV head) to finish, found
//   through an atomic counter, merges the partials with the rescale rule
//   in the same launch and zeroes its counter again. The wrapper chooses
//   n_splits so that the grid fills the card
//   (ops/paged_attention.py::split_kv_plan).
//
// float32, and bf16 with 16 < S*G < 64 rows (off the serving path), keep
// the CUDA-core tile of attention_common.cuh: its card tests hold float32
// to summation order alone, which the tensor cores' TF32 would break.
#include "attention_common.cuh"
#include "hopper_attention.cuh"

#include <algorithm>

using namespace kattn;

// ---------------------------------------------------------------------------
// float32, and the bf16 shapes the two Hopper paths do not take: the
// CUDA-core tile of attention_common.cuh.

template <typename T, int D>
__global__ void __launch_bounds__(NT)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ pool,
                       const int* __restrict__ table, const int* __restrict__ kv_lens,
                       T* __restrict__ out, int S, int H, int Kv, int page,
                       int max_pages, float scale, float softcap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int kvl = max(0, min(kv_lens[b], max_pages * page));
  PagedSrc<T> src{pool + (size_t)2 * kv * D, pool + (size_t)(2 * kv + 1) * D,
                  table + (size_t)b * max_pages, page, 2LL * Kv * D};
  tile_attention<T, D>(q, out, src, S, H, H / Kv, b, kv, tile, kvl - S, kvl,
                       scale, softcap, smem);
}

// ---------------------------------------------------------------------------
// Prefill, bf16: the tensor-core tile with K/V boxes found through the table.

// A tile is whole boxes of min(page, 64) rows from pages of the slot's
// table: a box past the table's span repeats its last page. Rows past the
// last key are then pool rows of the table (finite, as the plain version,
// which multiplies them by p = 0, assumes too), and the mask drops them.
template <int D>
struct PagedTmaSrc {
  const CUtensorMap* pool;
  const int* trow;  // this slot's table row
  int page, box_rows, kv, max_pages;
  __device__ __forceinline__ void load(int k0, uint32_t k_dst, uint32_t v_dst,
                                       uint32_t bar) const {
    using Gm = hop::Geo<D>;
    for (int j = 0; j < hop::TK / box_rows; ++j) {
      const int kk = k0 + j * box_rows, p = min(kk / page, max_pages - 1);
      const int row = __ldg(trow + p) * page + (kk - p * page);
#pragma unroll
      for (int c = 0; c < Gm::NCH; ++c) {
        const uint32_t off = c * Gm::CHUNK + j * box_rows * Gm::CWB;
        hop::tma_load(k_dst + off, pool, bar, c * Gm::CW, 2 * kv, row);
        hop::tma_load(v_dst + off, pool, bar, c * Gm::CW, 2 * kv + 1, row);
      }
    }
  }
};

template <int D>
__global__ void __launch_bounds__(hop::NTHREADS)
paged_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap poolmap, const int* __restrict__ table,
                const int* __restrict__ kv_lens, __nv_bfloat16* __restrict__ out, int S, int H,
                int Kv, int page, int max_pages, float scale, float softcap) {
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const int kv = blockIdx.x, b = blockIdx.y, tile = gridDim.z - 1 - blockIdx.z;
  const int kvl = max(0, min(kv_lens[b], max_pages * page));
  PagedTmaSrc<D> src{&poolmap, table + (size_t)b * max_pages, page, min(page, hop::TK), kv,
                     max_pages};
  hop::TileArgs a{out, S, H, H / Kv, b, kv, tile, kvl - S, kvl, scale, softcap};
  hop::tc_tile<D>(&qmap, src, a, tc_smem);
}

// ---------------------------------------------------------------------------
// Decode: split KV.

constexpr int DEC_T = 128;  // threads per decode block
constexpr int DEC_MAX_SPLITS = 64;

// Keys per split: a slot's kv_len cut into n_splits pieces of a multiple
// of 16 keys (so a split may end inside a page). Mirrored by
// kubeai_tpu_torch/ops/paged_attention.py::split_chunk.
__device__ __forceinline__ int split_chunk(int kvl, int n_splits) {
  const int c = (kvl + n_splits - 1) / n_splits;
  return max(16, (c + 15) & ~15);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// All but the newest copy group have landed.
__device__ __forceinline__ void cp_async_wait_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Where a split's block leaves its result.
struct SplitOut {
  void* out;  // [B, S, H, D]
  float* part_o;
  float2* part_ml;
  int* counters;
  int b, kv, S, H, G, R, bk, n_splits, split, live;
};

// The end of a split. O_s [R][D] (shared) holds the split's output before
// the division, m_s / l_s its running max and denominator per row. When
// the slot's keys were this one split, writes the output; else writes the
// partial, and the last block of (slot, KV head) to finish merges every
// split's partial: all (m, l) at once, per row the max M and 1 / sum(l
// e^(m-M)), each split's weight e^(m-M) / L, then the weighted sum.
template <typename T, int D>
__device__ __forceinline__ void split_finish(const SplitOut& so, const float* O_s, float* m_s,
                                             float* l_s, float2* w_s, int* last_flag) {
  const int tid = threadIdx.x, R = so.R, G = so.G, live = so.live;
  auto out_row = [&](int r) {
    const int s = r / G, g = r - s * G;
    return reinterpret_cast<T*>(so.out) + ((size_t)(so.b * so.S + s) * so.H + so.kv * G + g) * D;
  };
  if (live == 1) {
    for (int i = tid; i < R * D; i += DEC_T) {
      const int r = i / D;
      out_row(r)[i - r * D] = from_float<T>(O_s[i] / fmaxf(l_s[r], 1e-30f));
    }
    return;
  }
  float* po = so.part_o + ((size_t)so.bk * so.n_splits + so.split) * R * D;
  for (int i = tid * 4; i < R * D; i += DEC_T * 4)
    *reinterpret_cast<float4*>(po + i) = *reinterpret_cast<const float4*>(O_s + i);
  for (int r = tid; r < R; r += DEC_T)
    so.part_ml[((size_t)so.bk * so.n_splits + so.split) * R + r] = make_float2(m_s[r], l_s[r]);
  __threadfence();
  __syncthreads();
  if (tid == 0) *last_flag = atomicAdd(so.counters + so.bk, 1) == live - 1;
  __syncthreads();
  if (!*last_flag) return;
  __threadfence();

  const float2* ml = so.part_ml + (size_t)so.bk * so.n_splits * R;
  for (int i = tid; i < live * R; i += DEC_T) w_s[i] = __ldcg(ml + i);
  __syncthreads();
  for (int r = tid; r < R; r += DEC_T) {
    float M = NEG_INF;
    for (int sp = 0; sp < live; ++sp) M = fmaxf(M, w_s[sp * R + r].x);
    float L = 0.f;
    for (int sp = 0; sp < live; ++sp) L += w_s[sp * R + r].y * expf(w_s[sp * R + r].x - M);
    m_s[r] = M;
    l_s[r] = 1.f / fmaxf(L, 1e-30f);
  }
  __syncthreads();
  for (int i = tid; i < live * R; i += DEC_T) {
    const int r = i % R;
    w_s[i].x = expf(w_s[i].x - m_s[r]) * l_s[r];
  }
  __syncthreads();
  const float* pb = so.part_o + (size_t)so.bk * so.n_splits * R * D;
  for (int it = tid; it < R * (D / 4); it += DEC_T) {
    const int r = it / (D / 4), col = (it - r * (D / 4)) * 4;
    float o0 = 0.f, o1 = 0.f, o2 = 0.f, o3 = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < live; ++sp) {
      const float wgt = w_s[sp * R + r].x;
      const float4 v =
          __ldcg(reinterpret_cast<const float4*>(pb + ((size_t)sp * R + r) * D + col));
      o0 += v.x * wgt; o1 += v.y * wgt; o2 += v.z * wgt; o3 += v.w * wgt;
    }
    T* o = out_row(r) + col;
    o[0] = from_float<T>(o0);
    o[1] = from_float<T>(o1);
    o[2] = from_float<T>(o2);
    o[3] = from_float<T>(o3);
  }
  if (tid == 0) so.counters[so.bk] = 0;  // ready for the next launch on this stream
}

// The bf16 decode split on the tensor cores (rows R <= 16: one m16 tile),
// mma.sync m16n8k16 with f32 accumulators. Each warp walks its own 16-key
// slices of the split (slice w, w+4, ...) through a private K/V ring in
// shared memory, so warps never wait for each other inside the loop: Q
// sits in registers as the A fragments of S = Q K^T (rows past R zero),
// K arrives by ldmatrix as B, the softmax runs on S's accumulator
// fragments (a row's 16 keys in 4 lanes), and P, whose accumulator layout
// is the A-fragment layout of P V, enters P V as two bf16 terms (hi + lo)
// with V read by ldmatrix.trans. A slice's K and V rows (adjacent in the
// pool: 512 contiguous bytes per key at D = 128) are copied together, two
// slices in flight per warp. The four warps' (m, l, O) are combined at the
// end and split_finish takes over.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

constexpr int MMA_MAX_R = 16;
constexpr int SLICE = 16;  // keys per warp step

template <int D>
struct DecMma {
  static constexpr int NCHK = D / 8;                     // 16-byte chunks per row
  static constexpr int SWZ = (NCHK < 8 ? NCHK : 8) - 1;  // chunk swizzle mask
  static constexpr int ROWB = D * 2;
  static constexpr int WBUF = SLICE * ROWB;  // one slice's K (or V) rows
  static constexpr int RING = 4 * WBUF;      // a warp's two (K, V) stages
  // Warp rings (reused for the warps' O at the end), the combined O,
  // the warps' (m, l), m/l per row, the merge's (m, l) per split, a flag.
  static size_t smem(int R, int n_splits) {
    return (size_t)(DEC_T / 32) * RING + sizeof(float) * ((size_t)R * D + 2 * 64 + 2 * 64) +
           sizeof(float2) * (size_t)n_splits * R + 16;
  }
};

template <int D>
__global__ void __launch_bounds__(DEC_T)
paged_decode_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ pool, const int* __restrict__ table,
                        const int* __restrict__ kv_lens, __nv_bfloat16* __restrict__ out,
                        float* __restrict__ part_o, float2* __restrict__ part_ml,
                        int* __restrict__ counters, int S, int H, int Kv, int page,
                        int max_pages, float scale, float softcap) {
  using C = DecMma<D>;
  constexpr int NW = DEC_T / 32, NKS = D / 16, NN = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int split = blockIdx.x, kv = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int n_splits = gridDim.x, G = H / Kv, R = S * G, bk = b * Kv + kv;
  const int kvl = max(0, min(kv_lens[b], max_pages * page));
  const int chunk = split_chunk(kvl, n_splits);
  const int live = max(1, (kvl + chunk - 1) / chunk);
  if (split >= live) return;  // no keys here; the live splits merge without it
  const int k_lo = split * chunk, k_hi = min(k_lo + chunk, kvl);
  const int n_slices = max(0, (k_hi - k_lo + SLICE - 1) / SLICE);

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  unsigned char* ring = smem + warp * C::RING;  // stage st: K at 2*st*WBUF, V after
  float* O_c = reinterpret_cast<float*>(smem + NW * C::RING);  // [R][D]
  float* m_w = O_c + R * D;  // [NW][16]
  float* l_w = m_w + 64;
  float* m_s = l_w + 64;
  float* l_s = m_s + 64;
  float2* w_s = reinterpret_cast<float2*>(l_s + 64);
  int* last_flag = reinterpret_cast<int*>(w_s + n_splits * R);

  const int* trow = table + (size_t)b * max_pages;
  const long long rs = 2LL * Kv * D;
  const __nv_bfloat16* kbase = pool + (size_t)2 * kv * D;

  // This warp copies slice `sl`'s K and V rows into stage st, one group.
  auto issue = [&](int sl, int st) {
    const uint32_t dst = hop::smem_u32(ring) + st * 2 * C::WBUF;
    const int k0 = k_lo + sl * SLICE;
    for (int idx = lane; idx < SLICE * C::NCHK; idx += 32) {
      const int j = idx / C::NCHK, c = idx - j * C::NCHK, kpos = k0 + j;
      const __nv_bfloat16* src = kbase;
      int n = 0;
      if (kpos < k_hi) {
        const int p = kpos / page;
        src = kbase + ((long long)__ldg(trow + p) * page + (kpos - p * page)) * rs + c * 8;
        n = 16;
      }
      const uint32_t off = j * C::ROWB + ((c ^ (j & C::SWZ)) * 16);
      cp_async16(dst + off, src, n);
      cp_async16(dst + C::WBUF + off, src + D, n);
    }
    cp_async_commit();
  };

  const int my_n = n_slices > warp ? (n_slices - warp + NW - 1) / NW : 0;
  if (my_n > 0) issue(warp, 0);
  if (my_n > 1) issue(warp + NW, 1); else cp_async_commit();
  // Q as A fragments: a0 (row g, k 2t), a1 (row g+8, k 2t), a2 (row g,
  // k 2t+8), a3 (row g+8, k 2t+8) of every 16-column step.
  uint32_t qa[NKS][4];
  int qp[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = g + 8 * h;
    qp[h] = r < R ? kvl - S + r / G : -1;  // -1: a padding row sees no key
    const __nv_bfloat16* qr =
        q + ((size_t)(b * S + r / G) * H + kv * G + r % G) * D + 2 * t4;
#pragma unroll
    for (int kk = 0; kk < NKS; ++kk) {
      qa[kk][h] = r < R ? *reinterpret_cast<const uint32_t*>(qr + kk * 16) : 0u;
      qa[kk][2 + h] = r < R ? *reinterpret_cast<const uint32_t*>(qr + kk * 16 + 8) : 0u;
    }
  }

  float o[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.f, l_hi = 0.f;
  const int lrow = lane & 7, lmat = lane >> 3;

  for (int i = 0; i < my_n; ++i) {
    const int sl = warp + i * NW, k0 = k_lo + sl * SLICE;
    const uint32_t kb_a = hop::smem_u32(ring) + (i & 1) * 2 * C::WBUF, vb_a = kb_a + C::WBUF;
    cp_async_wait_but_one();  // this slice (the next may still be in flight)
    __syncwarp();
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    {
      const int key = (lmat >> 1) * 8 + lrow;
#pragma unroll
      for (int kk = 0; kk < NKS; ++kk) {
        const int c = 2 * kk + (lmat & 1);
        uint32_t bk4[4];
        ldsm_x4(kb_a + key * C::ROWB + ((c ^ (key & C::SWZ)) * 16), bk4);
        mma_bf16(sc[0], qa[kk], bk4[0], bk4[1]);
        mma_bf16(sc[1], qa[kk], bk4[2], bk4[3]);
      }
    }

    // Scale, softcap, mask; online softmax of rows g (lo) and g+8 (hi).
    float mx_lo = NEG_INF, mx_hi = NEG_INF;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[nt][e] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const int key = k0 + nt * 8 + 2 * t4 + (e & 1);
        if (!(key < k_hi && key <= qp[e >> 1])) x = NEG_INF;
        sc[nt][e] = x;
        if (e < 2) mx_lo = fmaxf(mx_lo, x); else mx_hi = fmaxf(mx_hi, x);
      }
    }
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = sc[nt][e];
        const float p = x > NEG_INF / 2 ? expf(x - (e < 2 ? mn_lo : mn_hi)) : 0.f;
        sc[nt][e] = p;
        if (e < 2) sum_lo += p; else sum_hi += p;
      }
    }
    sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, 1);
    sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, 2);
    sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, 1);
    sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, 2);
    const float al_lo = expf(m_lo - mn_lo), al_hi = expf(m_hi - mn_hi);
    l_lo = l_lo * al_lo + sum_lo;
    l_hi = l_hi * al_hi + sum_hi;
    m_lo = mn_lo;
    m_hi = mn_hi;
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      o[n][0] *= al_lo; o[n][1] *= al_lo;
      o[n][2] *= al_hi; o[n][3] *= al_hi;
    }
    uint32_t ph[4], pl[4];
    hop::split_bf16(sc[0][0], sc[0][1], ph[0], pl[0]);
    hop::split_bf16(sc[0][2], sc[0][3], ph[1], pl[1]);
    hop::split_bf16(sc[1][0], sc[1][1], ph[2], pl[2]);
    hop::split_bf16(sc[1][2], sc[1][3], ph[3], pl[3]);

    {
      const int key = (lmat & 1) * 8 + lrow;
#pragma unroll
      for (int np = 0; np < NN / 2; ++np) {
        const int c = 2 * np + (lmat >> 1);
        uint32_t bv[4];
        ldsm_x4_trans(vb_a + key * C::ROWB + ((c ^ (key & C::SWZ)) * 16), bv);
        mma_bf16(o[2 * np], ph, bv[0], bv[1]);
        mma_bf16(o[2 * np], pl, bv[0], bv[1]);
        mma_bf16(o[2 * np + 1], ph, bv[2], bv[3]);
        mma_bf16(o[2 * np + 1], pl, bv[2], bv[3]);
      }
    }
    __syncwarp();
    if (i + 2 < my_n) issue(sl + 2 * NW, i & 1); else cp_async_commit();
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // Combine the warps: O_w [NW][R][D] over the rings, then per (row,
  // column) the rescaled sum into O_c, with m_s / l_s per row.
  float* O_w = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = g + 8 * h;
    if (r >= R) continue;
#pragma unroll
    for (int n = 0; n < NN; ++n)
      *reinterpret_cast<float2*>(O_w + ((size_t)warp * R + r) * D + n * 8 + 2 * t4) =
          make_float2(o[n][2 * h], o[n][2 * h + 1]);
    if (t4 == 0) {
      m_w[warp * 16 + r] = h ? m_hi : m_lo;
      l_w[warp * 16 + r] = h ? l_hi : l_lo;
    }
  }
  __syncthreads();
  for (int r = tid; r < R; r += DEC_T) {
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, m_w[w * 16 + r]);
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) L += l_w[w * 16 + r] * expf(m_w[w * 16 + r] - M);
    m_s[r] = M;
    l_s[r] = L;
  }
  __syncthreads();
  for (int i = tid; i < R * D; i += DEC_T) {
    const int r = i / D;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) v += O_w[(size_t)w * R * D + i] * expf(m_w[w * 16 + r] - m_s[r]);
    O_c[i] = v;
  }
  __syncthreads();
  const SplitOut so{out, part_o, part_ml, counters, b, kv, S, H, G, R, bk, n_splits, split, live};
  split_finish<__nv_bfloat16, D>(so, O_c, m_s, l_s, w_s, last_flag);
}

// ---------------------------------------------------------------------------
// Launchers.

struct PagedArgs {
  const void* q;
  const void* pool;
  const int* table;
  const int* kv_lens;
  void* out;
  float* part_o;
  float2* part_ml;
  int* counters;
  int B, S, H, Kv, P, page, max_pages, n_splits;
  float scale, softcap;
};

template <int D>
static int launch_decode_mma(const PagedArgs& a, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      paged_decode_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (attr != cudaSuccess) return (int)attr;
  const int R = a.S * (a.H / a.Kv);
  dim3 grid(a.n_splits, a.Kv, a.B);
  paged_decode_mma_kernel<D><<<grid, DEC_T, DecMma<D>::smem(R, a.n_splits), stream>>>(
      (const __nv_bfloat16*)a.q, (const __nv_bfloat16*)a.pool, a.table, a.kv_lens,
      (__nv_bfloat16*)a.out, a.part_o, a.part_ml, a.counters, a.S, a.H, a.Kv, a.page,
      a.max_pages, a.scale, a.softcap);
  return (int)cudaGetLastError();
}

template <typename T, int D>
static int launch_core(const PagedArgs& a, cudaStream_t stream) {
  const size_t smem = tile_smem_bytes<D>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      paged_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const int G = a.H / a.Kv;
  dim3 grid((a.S * G + BQ - 1) / BQ, a.Kv, a.B);
  paged_attention_kernel<T, D><<<grid, NT, smem, stream>>>(
      (const T*)a.q, (const T*)a.pool, a.table, a.kv_lens, (T*)a.out, a.S, a.H, a.Kv, a.page,
      a.max_pages, a.scale, a.softcap);
  return (int)cudaGetLastError();
}

template <int D>
static int launch_tc(const PagedArgs& a, cudaStream_t stream) {
  using Gm = hop::Geo<D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      paged_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Gm::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const int G = a.H / a.Kv;
  CUtensorMap qm, pm;
  int e = hop::tensor_map(&qm, a.q, (uint64_t)a.B * a.S, a.H, D, hop::TQ / G, G, Gm::CW,
                          Gm::SWIZZLE);
  if (!e)
    e = hop::tensor_map(&pm, a.pool, (uint64_t)a.P * a.page, 2 * a.Kv, D,
                        std::min(a.page, hop::TK), 1, Gm::CW, Gm::SWIZZLE);
  if (e) return e;
  dim3 grid(a.Kv, a.B, (a.S * G + hop::TQ - 1) / hop::TQ);
  paged_tc_kernel<D><<<grid, hop::NTHREADS, Gm::SMEM, stream>>>(
      qm, pm, a.table, a.kv_lens, (__nv_bfloat16*)a.out, a.S, a.H, a.Kv, a.page, a.max_pages,
      a.scale, a.softcap);
  return (int)cudaGetLastError();
}

template <typename T, int D>
static int launch(const PagedArgs& a, cudaStream_t stream) {
  const int G = a.H / a.Kv, R = a.S * G;
  if (sizeof(T) == 2 && R <= MMA_MAX_R) {
    if (a.n_splits < 1 || a.n_splits > DEC_MAX_SPLITS) return (int)cudaErrorInvalidValue;
    return launch_decode_mma<D>(a, stream);
  }
  // The TMA path takes pages of 8 rows or more that tile 64 keys evenly.
  const bool tma_pages = a.page % 8 == 0 && (hop::TK % a.page == 0 || a.page % hop::TK == 0);
  if (sizeof(T) == 2 && R >= hop::TQ && hop::TQ % G == 0 && tma_pages)
    return launch_tc<D>(a, stream);
  return launch_core<T, D>(a, stream);
}

// dtype: 0 = float32, 1 = bfloat16; D: 32, 64 or 128. P: pages in the pool.
// bf16 decode (S*G <= 16) cuts each slot's keys into n_splits (1..64)
// splits and takes the wrapper's scratch: part_o [B*Kv*n_splits*S*G*D] f32,
// part_ml [B*Kv*n_splits*S*G] float2, counters [B*Kv] int32 (zero, and
// left zero).
// Returns a cudaError_t (0 = launched).
extern "C" int paged_attention_launch(const void* q, const void* pool, const void* table,
                                      const void* kv_lens, void* out, void* part_o,
                                      void* part_ml, void* counters, int B, int S, int H,
                                      int Kv, int D, int P, int page, int max_pages,
                                      int n_splits, int dtype,
                                      float scale, float softcap, void* stream) {
  PagedArgs a{q, pool, (const int*)table, (const int*)kv_lens, out, (float*)part_o,
              (float2*)part_ml, (int*)counters, B, S, H, Kv, P, page, max_pages, n_splits,
              scale, softcap};
  KATTN_DISPATCH(launch, dtype, D, a, (cudaStream_t)stream);
}
