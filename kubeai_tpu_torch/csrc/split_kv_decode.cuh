// Split-KV decode on the tensor cores, shared by the decode and verify
// regime of the ragged paged kernel (paged_attention.cu) and the dedicated
// decode kernel (paged_decode_attention.cu): one, two or four row tiles.
//
// The function: the R = S*G query rows of one (slot b, KV head kv), row
// r = s*G + g being query s of head kv*G + g at position kv_len - S + s,
// attend to the slot's keys 0 .. kv_len-1, found by walking page_table[b]
// over the pool [L*P, page, 2*Kv, D] (K at head 2kv, V at 2kv+1; the table
// already carries the layer's offset; kv_len clamped to the table span).
// Softcap before the mask; bf16 in and out, f32 accumulation.
//
// Bound on the H100: bytes. Every valid K/V byte is read once (B=8,
// kv_len 512: ~16.8 MB per layer call, ~5 us at 3.35 TB/s); one key of
// one KV head is 512 bytes for 4*D*R flops, R <= 64 flops a byte, far
// under the ~295 at which the tensor cores would bound it.
//
// Design, and what each part does about the bound:
// * Row groups. A block takes at most 64 of the R rows (four m16 tiles):
//   a verify step with more rows (S*G > 64: S > 16 at G = 4, any S at
//   G > 64) cuts them into groups of group_rows consecutive rows, each a
//   set of blocks of its own (grid.x = n_splits * groups) with its own
//   scratch region. Each group reads the slot's keys again; at 64 rows
//   per group a key is reused 64 times from shared memory, and verify
//   shapes above it (S > 16) are off the serving path's defaults.
// * Split KV (flash-decoding): block (split, kv, b) takes the split-th of
//   n_splits pieces of its slot's own kv_len (split_chunk: multiples of
//   16 keys, so a split may end inside a page), so the grid fills the
//   card at small B*Kv; the wrapper picks n_splits
//   (ops/paged_attention.py::split_kv_plan).
// * Key streams and row tiles. A block's four warps form NS = 4 / MT key
//   streams of MT warps each; stream j walks 16-key slices j, j+NS, ...
//   of the split, and the MT warps of a stream share each slice, warp w
//   owning m16 row tile w % MT. Every warp thus holds one tile's state,
//   whatever the tile count: Q as A fragments (32 registers at D = 128),
//   O as accumulators (64), so no instance spills. At D = 256 (Gemma) O
//   alone takes 128 registers, and Q's fragments wait in shared memory
//   (32 KB a block), read back once per slice. Measured on the H100
//   at R = 32: warps that each held both tiles over four streams used 255
//   registers, spilled, and were 7% slower than two warps per stream;
//   four tiles per warp do not fit at all.
// * Copies in flight during the products. Each stream keeps a ring of
//   2*MT stages in shared memory (64 KB per block at D = 128, every tile
//   count); a slice's K and V rows (adjacent in the pool: 512 contiguous
//   bytes per key at D = 128) are copied together by cp.async, each warp
//   of the stream taking its share, with 2*MT - 1 slices of the stream in
//   flight while one is computed. On the H100 a ring one stage deeper
//   was 1.5 us faster at kv_len 2048 but 1 us slower at kv_len 512 and
//   below, where decode spends its time.
// * Products on the tensor cores: mma.sync m16n8k16 bf16, f32
//   accumulators. S = Q K^T takes K by ldmatrix as B; the softmax runs on
//   S's accumulator fragments (a row's 16 keys in 4 lanes); P, whose
//   accumulator layout is the A-fragment layout of P V, enters P V as two
//   bf16 terms (hi + lo, split_bf16) with V read by ldmatrix.trans.
//   (wgmma would waste at least half of each product: its M is 64 rows.)
// * Merge in the same launch: the streams' (m, l, O) are combined in
//   shared memory; when the slot's keys span several splits each block
//   writes its partial to f32 scratch and the last block of the (slot,
//   KV head), found through an atomic counter that it leaves at zero,
//   merges them with the rescale rule (split_finish). The merge reads
//   the partials from L2 with all of a split's loads in flight at once:
//   at R = 32 (B=8, kv_len 512) a merge that used each load as it came
//   took ~10 us of the kernel's 33 on the H100; batched, the kernel
//   takes 28.
// * A one-byte pool (KT int8_t or __nv_fp8_e4m3: the quantized pool of
//   the JAX package's _decode_kernel, which multiplies each page by the
//   static k_scale / v_scale after loading it) halves the bytes, and with
//   them the bound (~8.4 MB, ~2.5 us at B=8, kv_len 512). The copies move
//   the one-byte rows (D bytes each) into a staging ring of the same
//   depth; after a slice lands, the warps of its stream widen it into one
//   bf16 stage in the swizzled layout of the bf16 ring (exactly: int8 by
//   PRMT + FADD, e4m3 by the hardware's e4m3x2 -> f16x2 conversion), meet
//   again, and the mma.sync code reads that stage as it reads the bf16
//   ring. The scales cost nothing per element: k_scale folds into the
//   softmax scale and v_scale into the output's final 1 / l (exact
//   rewrites; attention_common.cuh). Widening in registers while the B
//   fragments are built would save the bf16 stage and a meeting per
//   slice; it is left for a later redesign.
#pragma once

#include "attention_common.cuh"

namespace kdec {

using namespace kattn;

constexpr int DEC_T = 128;          // threads per block
constexpr int DEC_NW = DEC_T / 32;  // warps per block
constexpr int DEC_MAX_SPLITS = 64;
constexpr int SLICE = 16;           // keys per step of a key stream

// Keys per split: a slot's kv_len cut into n_splits pieces of a multiple
// of 16 keys. Mirrored by kubeai_tpu_torch/ops/paged_attention.py::split_chunk.
__device__ __forceinline__ int split_chunk(int kvl, int n_splits) {
  const int c = (kvl + n_splits - 1) / n_splits;
  return max(16, (c + 15) & ~15);
}

// A 16-byte copy; src_bytes 0 fills the destination with zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// All but the newest N copy groups of this thread have landed.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Named barrier ID over THREADS threads (whole warps). Immediate IDs: a
// barrier named by a register reserves all 16 of the block's barriers.
template <int ID, int THREADS>
__device__ __forceinline__ void named_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(ID), "n"(THREADS) : "memory");
}

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

// Where a split's block leaves its result.
struct SplitOut {
  void* out;  // [B, S, H, D]
  float* part_o;
  float2* part_ml;
  int* counters;
  int b, kv, S, H, G, R, r0, bk, n_splits, split, live;  // rows r0 .. r0+R-1
  float out_scale;  // the output's factor: a quantized pool's v_scale, else 1
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
    const int s = (so.r0 + r) / G, g = so.r0 + r - s * G;
    return reinterpret_cast<T*>(so.out) + ((size_t)(so.b * so.S + s) * so.H + so.kv * G + g) * D;
  };
  if (live == 1) {
    for (int i = tid; i < R * D; i += DEC_T) {
      const int r = i / D;
      out_row(r)[i - r * D] = from_float<T>(O_s[i] / fmaxf(l_s[r], 1e-30f) * so.out_scale);
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
    l_s[r] = so.out_scale / fmaxf(L, 1e-30f);
  }
  __syncthreads();
  for (int i = tid; i < live * R; i += DEC_T) {
    const int r = i % R;
    w_s[i].x = expf(w_s[i].x - m_s[r]) * l_s[r];
  }
  __syncthreads();
  // U groups of 4 columns per thread: every split's U loads are issued
  // before any of them is used (the partials come from L2; a load per
  // use would wait out each round trip in turn). Items past the end
  // load a valid address and are not stored.
  constexpr int U = 8;
  const int n_items = R * (D / 4);
  const float* pb = so.part_o + (size_t)so.bk * so.n_splits * R * D;
  for (int it0 = tid; it0 < n_items; it0 += DEC_T * U) {
    int row[U], off[U];
    float4 acc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int it = min(it0 + u * DEC_T, n_items - 1);
      row[u] = it / (D / 4);
      off[u] = row[u] * D + (it - row[u] * (D / 4)) * 4;
      acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int sp = 0; sp < live; ++sp) {
      const float* ps = pb + (size_t)sp * R * D;
      float4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) v[u] = __ldcg(reinterpret_cast<const float4*>(ps + off[u]));
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float wgt = w_s[sp * R + row[u]].x;
        acc[u].x += v[u].x * wgt; acc[u].y += v[u].y * wgt;
        acc[u].z += v[u].z * wgt; acc[u].w += v[u].w * wgt;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (it0 + u * DEC_T >= n_items) break;
      T* o = out_row(row[u]) + (off[u] - row[u] * D);
      o[0] = from_float<T>(acc[u].x);
      o[1] = from_float<T>(acc[u].y);
      o[2] = from_float<T>(acc[u].z);
      o[3] = from_float<T>(acc[u].w);
    }
  }
  if (tid == 0) so.counters[so.bk] = 0;  // ready for the next launch on this stream
}

// Geometry of the instance with MT m16 row tiles (R <= 16 * MT) over a
// pool of KT (bf16, or one byte per element).
template <int D, int MT, typename KT = __nv_bfloat16>
struct DecMma {
  static constexpr bool Q8 = sizeof(KT) == 1;  // one-byte pool: staged, then widened
  static constexpr int WR = MT;               // warps per key stream, one row tile each
  static constexpr int NS = DEC_NW / WR;      // key streams per block
  static constexpr int NST = 2 * WR;          // ring stages per stream
  static constexpr int NCHK = D / 8;                     // 16-byte bf16 chunks per row
  static constexpr int SWZ = (NCHK < 8 ? NCHK : 8) - 1;  // chunk swizzle mask
  static constexpr int ROWB = D * 2;
  static constexpr int WBUF = SLICE * ROWB;  // one slice's K (or V) rows, bf16
  static constexpr int STAGE = 2 * WBUF;     // a slice's K and V, bf16
  static constexpr int ROWB_IN = D * (int)sizeof(KT);  // a pool row's bytes
  static constexpr int NCHK_IN = ROWB_IN / 16;         // its 16-byte copies
  static constexpr int WBUF_IN = SLICE * ROWB_IN;
  static constexpr int STAGE_IN = 2 * WBUF_IN;         // a ring stage
  // The rings (one per stream) and, for a one-byte pool, one bf16 stage
  // per stream after them.
  static constexpr int RING = NS * NST * STAGE_IN + (Q8 ? NS * STAGE : 0);
  // After the walk the rings hold the streams' O [NS][R][D] (NS*R <= 64
  // rows) and the combined O [R][D], both f32.
  static constexpr int OBYTES = (DEC_NW * 16 + 16 * MT) * D * 4;
  static constexpr int BIG = RING > OBYTES ? RING : OBYTES;
  // Head dim 256: Q's A fragments (64 registers a thread) wait in shared
  // memory, one 16-byte word per (k step, warp, lane), beside O's 128
  // accumulator registers, so the instance does not spill.
  static constexpr bool QSM = D >= 256;
  static constexpr int QBYTES = QSM ? (D / 16) * DEC_NW * 32 * 16 : 0;
  // Rings, Q (QSM), the streams' (m, l), m/l per row, the merge's (m, l)
  // per split, a flag.
  static size_t smem(int R, int n_splits) {
    return (size_t)BIG + QBYTES + sizeof(float) * 4 * 64 + sizeof(float2) * (size_t)n_splits * R +
           16;
  }
};

template <int D, int MT, typename KT>
__global__ void __launch_bounds__(DEC_T)
paged_decode_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const KT* __restrict__ pool, const int* __restrict__ table,
                        const int* __restrict__ kv_lens, __nv_bfloat16* __restrict__ out,
                        float* __restrict__ part_o, float2* __restrict__ part_ml,
                        int* __restrict__ counters, int S, int H, int Kv, int page,
                        int max_pages, int n_splits, int group_rows, float scale,
                        float softcap, float out_scale) {
  using C = DecMma<D, MT, KT>;
  constexpr int NKS = D / 16, NN = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int grp = blockIdx.x / n_splits, split = blockIdx.x - grp * n_splits;
  const int kv = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int G = H / Kv, r0 = grp * group_rows, R = min(group_rows, S * G - r0);
  const int bk = b * Kv + kv;
  const int kvl = max(0, min(kv_lens[b], max_pages * page));
  const int chunk = split_chunk(kvl, n_splits);
  const int live = max(1, (kvl + chunk - 1) / chunk);
  if (split >= live) return;  // no keys here; the live splits merge without it
  const int k_lo = split * chunk, k_hi = min(k_lo + chunk, kvl);
  const int n_slices = max(0, (k_hi - k_lo + SLICE - 1) / SLICE);

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int stream = warp / C::WR, rt = warp % C::WR;  // key stream, row tile
  unsigned char* ring = smem + stream * C::NST * C::STAGE_IN;
  // A one-byte pool's bf16 stage of this stream, after the rings.
  unsigned char* wide = smem + C::NS * C::NST * C::STAGE_IN + stream * C::STAGE;
  float* O_w = reinterpret_cast<float*>(smem);  // [NS][R][D], over the rings
  float* O_c = O_w + DEC_NW * 16 * D;           // [R][D]
  uint4* q_sm = reinterpret_cast<uint4*>(smem + C::BIG) + warp * 32 + lane;  // + kk * 128
  float* m_w = reinterpret_cast<float*>(smem + C::BIG + C::QBYTES);  // [NS][R]
  float* l_w = m_w + 64;
  float* m_s = l_w + 64;
  float* l_s = m_s + 64;
  float2* w_s = reinterpret_cast<float2*>(l_s + 64);
  int* last_flag = reinterpret_cast<int*>(w_s + n_splits * R);

  const int* trow = table + (size_t)b * max_pages;
  const long long rs = 2LL * Kv * D;
  const KT* kbase = pool + (size_t)2 * kv * D;

  // This warp's share of the copy of the stream's i-th slice (K and V
  // rows) into stage i % NST: bf16 rows swizzled by 16-byte chunk, one-byte
  // rows as they are. Rows past the split's last key are zeros.
  auto issue = [&](int i) {
    const uint32_t dst = smem_u32(ring) + (i % C::NST) * C::STAGE_IN;
    const int k0 = k_lo + (stream + i * C::NS) * SLICE;
    for (int idx = rt * 32 + lane; idx < SLICE * C::NCHK_IN; idx += 32 * C::WR) {
      const int j = idx / C::NCHK_IN, c = idx - j * C::NCHK_IN, kpos = k0 + j;
      const KT* src = kbase;
      int n = 0;
      if (kpos < k_hi) {
        const int p = kpos / page;
        src = kbase + ((long long)__ldg(trow + p) * page + (kpos - p * page)) * rs +
              c * (16 / (int)sizeof(KT));
        n = 16;
      }
      const uint32_t off =
          C::Q8 ? j * C::ROWB_IN + c * 16 : j * C::ROWB + ((c ^ (j & C::SWZ)) * 16);
      cp_async16(dst + off, src, n);
      cp_async16(dst + C::WBUF_IN + off, src + D, n);
    }
  };
  // A one-byte pool: this warp's share of widening the stream's landed
  // slice i into its bf16 stage (the layout issue() gives a bf16 slice).
  auto widen = [&](int i) {
    const unsigned char* in = ring + (i % C::NST) * C::STAGE_IN;
    constexpr int UNITS = SLICE * C::NCHK;  // 8-element units of K (and of V)
    for (int u = rt * 32 + lane; u < 2 * UNITS; u += 32 * C::WR) {
      const int kvs = u >= UNITS, w = u - kvs * UNITS, j = w / C::NCHK, c = w - j * C::NCHK;
      const uint2 bytes =
          *reinterpret_cast<const uint2*>(in + kvs * C::WBUF_IN + j * C::ROWB_IN + c * 8);
      *reinterpret_cast<uint4*>(wide + kvs * C::WBUF + j * C::ROWB + ((c ^ (j & C::SWZ)) * 16)) =
          widen8_bf16<KT>(bytes);
    }
  };
  // The warps of a stream meet once per slice: after it, every share of
  // the slice has landed and every warp is done with the previous one.
  auto stream_sync = [&] {
    if constexpr (C::WR == 1)
      __syncwarp();
    else if constexpr (C::NS == 1)
      __syncthreads();
    else if (stream == 0)
      named_sync<1, 32 * C::WR>();
    else
      named_sync<2, 32 * C::WR>();
  };
  static_assert(C::WR == 1 || C::NS <= 2, "named barriers for at most two streams");

  const int my_n = n_slices > stream ? (n_slices - stream + C::NS - 1) / C::NS : 0;
#pragma unroll
  for (int i = 0; i < C::NST - 1; ++i) {
    if (i < my_n) issue(i);
    cp_async_commit();
  }
  // Q as A fragments: a0 (row g, k 2t), a1 (row g+8, k 2t), a2 (row g,
  // k 2t+8), a3 (row g+8, k 2t+8) of every 16-column step.
  // (QSM: in this thread's words of q_sm, read back at each slice.)
  uint32_t qa[C::QSM ? 1 : NKS][4];
  int qp[2];
  const __nv_bfloat16* qr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rt * 16 + g + 8 * h, rr = r0 + r;
    qp[h] = r < R ? kvl - S + rr / G : -1;  // -1: a padding row sees no key
    qr[h] = r < R ? q + ((size_t)(b * S + rr / G) * H + kv * G + rr % G) * D + 2 * t4 : nullptr;
  }
#pragma unroll
  for (int kk = 0; kk < NKS; ++kk) {
    uint32_t f[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      f[h] = qr[h] ? *reinterpret_cast<const uint32_t*>(qr[h] + kk * 16) : 0u;
      f[2 + h] = qr[h] ? *reinterpret_cast<const uint32_t*>(qr[h] + kk * 16 + 8) : 0u;
    }
    if constexpr (C::QSM) {
      q_sm[kk * DEC_T] = make_uint4(f[0], f[1], f[2], f[3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[kk][i] = f[i];
    }
  }

  float o[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.f, l_hi = 0.f;
  const int lrow = lane & 7, lmat = lane >> 3;

  for (int i = 0; i < my_n; ++i) {
    cp_async_wait<C::NST - 2>();  // this thread's share of slice i
    stream_sync();
    if (i + C::NST - 1 < my_n) issue(i + C::NST - 1);  // into the stage of slice i-1
    cp_async_commit();
    if constexpr (C::Q8) {
      // The stream's bf16 stage is free: every warp passed the meeting
      // above after its products of slice i-1.
      widen(i);
      stream_sync();
    }
    const int k0 = k_lo + (stream + i * C::NS) * SLICE;
    const uint32_t kb_a =
        C::Q8 ? smem_u32(wide) : smem_u32(ring) + (i % C::NST) * C::STAGE;
    const uint32_t vb_a = kb_a + C::WBUF;
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    {
      const int key = (lmat >> 1) * 8 + lrow;
#pragma unroll
      for (int kk = 0; kk < NKS; ++kk) {
        const int c = 2 * kk + (lmat & 1);
        uint32_t bk4[4];
        ldsm_x4(kb_a + key * C::ROWB + ((c ^ (key & C::SWZ)) * 16), bk4);
        if constexpr (C::QSM) {
          const uint4 w = q_sm[kk * DEC_T];
          const uint32_t a[4] = {w.x, w.y, w.z, w.w};
          mma_bf16(sc[0], a, bk4[0], bk4[1]);
          mma_bf16(sc[1], a, bk4[2], bk4[3]);
        } else {
          mma_bf16(sc[0], qa[kk], bk4[0], bk4[1]);
          mma_bf16(sc[1], qa[kk], bk4[2], bk4[3]);
        }
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
    split_bf16(sc[0][0], sc[0][1], ph[0], pl[0]);
    split_bf16(sc[0][2], sc[0][3], ph[1], pl[1]);
    split_bf16(sc[1][0], sc[1][1], ph[2], pl[2]);
    split_bf16(sc[1][2], sc[1][3], ph[3], pl[3]);

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
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // Combine the streams: O_w [NS][R][D] over the rings, then per (row,
  // column) the rescaled sum into O_c, with m_s / l_s per row.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rt * 16 + g + 8 * h;
    if (r >= R) continue;
#pragma unroll
    for (int n = 0; n < NN; ++n)
      *reinterpret_cast<float2*>(O_w + ((size_t)stream * R + r) * D + n * 8 + 2 * t4) =
          make_float2(o[n][2 * h], o[n][2 * h + 1]);
    if (t4 == 0) {
      m_w[stream * R + r] = h ? m_hi : m_lo;
      l_w[stream * R + r] = h ? l_hi : l_lo;
    }
  }
  __syncthreads();
  // Per row the max M and sum L over the streams, and each stream's
  // weight e^(m - M) in place of its m.
  for (int r = tid; r < R; r += DEC_T) {
    float M = NEG_INF;
#pragma unroll
    for (int s = 0; s < C::NS; ++s) M = fmaxf(M, m_w[s * R + r]);
    float L = 0.f;
#pragma unroll
    for (int s = 0; s < C::NS; ++s) {
      const float w = expf(m_w[s * R + r] - M);
      L += l_w[s * R + r] * w;
      m_w[s * R + r] = w;
    }
    m_s[r] = M;
    l_s[r] = L;
  }
  __syncthreads();
  for (int i = tid; i < R * D; i += DEC_T) {
    const int r = i / D;
    float v = 0.f;
#pragma unroll
    for (int s = 0; s < C::NS; ++s) v += O_w[(size_t)s * R * D + i] * m_w[s * R + r];
    O_c[i] = v;
  }
  __syncthreads();
  // This row group's scratch region, offset here, after the walk: the
  // pointers stay kernel parameters through it.
  const int grp_end = blockIdx.x / n_splits;
  const size_t g_rows = (size_t)grp_end * gridDim.z * Kv * n_splits * group_rows;
  const SplitOut so{out, part_o + g_rows * D, part_ml + g_rows, counters + grp_end * gridDim.z * Kv,
                    b,   kv,     S,      H,      G,    R,    grp_end * group_rows, bk,
                    n_splits, split, live, out_scale};
  split_finish<__nv_bfloat16, D>(so, O_c, m_s, l_s, w_s, last_flag);
}

struct DecodeArgs {
  const void* q;
  const void* pool;
  const int* table;
  const int* kv_lens;
  void* out;
  float* part_o;    // [groups*B*Kv*n_splits*group_rows*D]
  float2* part_ml;  // [groups*B*Kv*n_splits*group_rows]
  int* counters;    // [groups*B*Kv], zero, and left zero
  int B, S, H, Kv, page, max_pages, n_splits;
  int group_rows;  // rows per block's group (R = S*G when R <= 64)
  float scale, softcap;
  float k_scale, v_scale;  // a quantized pool's dequant scales (1 otherwise)
};

// One launch of the instance with MT row tiles (group_rows <= 16 * MT, 1
// <= n_splits <= DEC_MAX_SPLITS) over a pool of KT. Returns a cudaError_t.
template <int D, int MT, typename KT>
static int launch_decode_mma(const DecodeArgs& a, cudaStream_t stream) {
  // Once per instance, at the per-block limit: the wrappers refuse shapes
  // that need more.
  static const cudaError_t attr = cudaFuncSetAttribute(
      paged_decode_mma_kernel<D, MT, KT>, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (attr != cudaSuccess) return (int)attr;
  const int R = a.S * (a.H / a.Kv), RG = a.group_rows;
  if (RG < 1 || RG > 16 * MT || a.n_splits < 1 || a.n_splits > DEC_MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  dim3 grid(a.n_splits * ((R + RG - 1) / RG), a.Kv, a.B);
  paged_decode_mma_kernel<D, MT, KT>
      <<<grid, DEC_T, DecMma<D, MT, KT>::smem(RG, a.n_splits), stream>>>(
          (const __nv_bfloat16*)a.q, (const KT*)a.pool, a.table, a.kv_lens,
          (__nv_bfloat16*)a.out, a.part_o, a.part_ml, a.counters, a.S, a.H, a.Kv, a.page,
          a.max_pages, a.n_splits, RG, a.scale * a.k_scale, a.softcap, a.v_scale);
  return (int)cudaGetLastError();
}

// The instance for group_rows rows: one, two or four m16 tiles.
template <int D, typename KT>
static int launch_split_kv(const DecodeArgs& a, cudaStream_t stream) {
  if (a.group_rows <= 16) return launch_decode_mma<D, 1, KT>(a, stream);
  if (a.group_rows <= 32) return launch_decode_mma<D, 2, KT>(a, stream);
  return launch_decode_mma<D, 4, KT>(a, stream);
}

// Shared-memory bytes of that instance.
template <int D, typename KT>
static size_t split_kv_smem(int group_rows, int n_splits) {
  if (group_rows <= 16) return DecMma<D, 1, KT>::smem(group_rows, n_splits);
  if (group_rows <= 32) return DecMma<D, 2, KT>::smem(group_rows, n_splits);
  return DecMma<D, 4, KT>::smem(group_rows, n_splits);
}

}  // namespace kdec
