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
// * Decode and speculative verify (S*G < 64: one token per slot, or a
//   verify step of S = G+1 <= 15 tokens at 4 query heads per KV head;
//   from 64 rows the wrapper takes the prefill tile, which at 64 rows
//   took under half this regime's time on the H100).
//   Bound: memory, every valid K/V byte once (B=8, kv_len 512: ~16.8 MB
//   per layer call, ~5 us at 3.35 TB/s). Split KV on the tensor cores
//   (split_kv_decode.cuh, which the dedicated decode kernel runs too):
//   one, two or four m16 row tiles by S*G, block (split, kv, b) streams
//   its piece of the slot's keys with cp.async, products by mma.sync, and
//   the last block of a (slot, KV head) merges the splits' partials in
//   the same launch. The wrapper takes this regime by passing n_splits >
//   0, chosen so that the grid fills the card
//   (ops/paged_attention.py::split_kv_plan).
//
// The prefill tile takes 64/G whole positions a tile, G*floor(64/G)
// rows (63 at Qwen2.5's G = 7, the last row padding), so G need not
// divide 64. Head dim 256 (Gemma's) runs every regime at 4 swizzle
// chunks of 64 columns (the KATTN_D256 library).
//
// float32 keeps the CUDA-core tile of attention_common.cuh in every
// regime (prefill, decode, verify): its card tests hold float32 to
// summation order alone, which the tensor cores' TF32 would break. At
// head dim 256 (a float32 Gemma: the KATTN_F32D256 library, float32 q
// over float32, int8 and fp8 pools) the tile takes 140,928 bytes of
// shared memory, which launch_core opts into on every launch path. bf16 takes it only where neither Hopper path does
// (more than 64 rows that the prefill tile cannot take: more than 64
// query heads per KV head, or pages off TMA's grid).
//
// A quantized pool (one byte per element, int8 or fp8 e4m3, with the
// static k_scale / v_scale the library kernel dequantizes with in VMEM)
// takes the same three paths at one byte per element, half the bytes of
// bf16: the prefill tile TMAs one-byte boxes through a UINT8 map of the
// pool and widens them to its bf16 stage (hopper_attention.cuh), the
// decode regime stages and widens its slices (split_kv_decode.cuh), the
// CUDA-core tile widens on load. Each folds k_scale into the softmax
// scale and v_scale into the output.
#include "attention_common.cuh"
#include "hopper_attention.cuh"
#include "split_kv_decode.cuh"
#include "preload.cuh"

#include <algorithm>

using namespace kattn;

// ---------------------------------------------------------------------------
// float32, and the bf16 shapes the two Hopper paths do not take: the
// CUDA-core tile of attention_common.cuh.

template <typename T, typename KT, int D>
__global__ void __launch_bounds__(NT)
paged_attention_kernel(const T* __restrict__ q, const KT* __restrict__ pool,
                       const int* __restrict__ table, const int* __restrict__ kv_lens,
                       T* __restrict__ out, int S, int H, int Kv, int page,
                       int max_pages, float scale, float softcap, float out_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int kvl = max(0, min(kv_lens[b], max_pages * page));
  PagedSrc<KT> src{pool + (size_t)2 * kv * D, pool + (size_t)(2 * kv + 1) * D,
                   table + (size_t)b * max_pages, page, 2LL * Kv * D};
  tile_attention<T, D, KT>(q, out, src, S, H, H / Kv, b, kv, tile, kvl - S, kvl,
                           scale, softcap, smem, out_scale);
}

// ---------------------------------------------------------------------------
// Prefill, bf16: the tensor-core tile with K/V boxes found through the table.

// A tile is whole boxes of min(page, 64) rows from pages of the slot's
// table: a box past the table's span repeats its last page. Rows past the
// last key are then pool rows of the table (finite, as the plain version,
// which multiplies them by p = 0, assumes too), and the mask drops them.
// A bf16 pool's boxes are CW columns wide and land swizzled in the bf16
// stage; a one-byte pool's span the head dim (D bytes) and land as rows
// of D bytes in the one-byte stage.
template <int D, typename KT>
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
      if constexpr (sizeof(KT) == 1) {
        const uint32_t off = j * box_rows * D;
        hop::tma_load(k_dst + off, pool, bar, 0, 2 * kv, row);
        hop::tma_load(v_dst + off, pool, bar, 0, 2 * kv + 1, row);
      } else {
#pragma unroll
        for (int c = 0; c < Gm::NCH; ++c) {
          const uint32_t off = c * Gm::CHUNK + j * box_rows * Gm::CWB;
          hop::tma_load(k_dst + off, pool, bar, c * Gm::CW, 2 * kv, row);
          hop::tma_load(v_dst + off, pool, bar, c * Gm::CW, 2 * kv + 1, row);
        }
      }
    }
  }
};

template <int D, typename KT>
__global__ void __launch_bounds__(hop::tile_threads<KT>())
paged_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap poolmap, const int* __restrict__ table,
                const int* __restrict__ kv_lens, __nv_bfloat16* __restrict__ out, int S, int H,
                int Kv, int page, int max_pages, float scale, float softcap, float out_scale) {
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const int kv = blockIdx.x, b = blockIdx.y, tile = gridDim.z - 1 - blockIdx.z;
  const int kvl = max(0, min(kv_lens[b], max_pages * page));
  PagedTmaSrc<D, KT> src{&poolmap, table + (size_t)b * max_pages, page, min(page, hop::TK), kv,
                         max_pages};
  hop::TileArgs a{out, S, H, H / Kv, b, kv, tile, kvl - S, kvl, scale, softcap, out_scale};
  hop::tc_tile<D, KT>(&qmap, src, a, tc_smem);
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
  float k_scale, v_scale;  // a quantized pool's dequant scales (1 otherwise)
};

template <typename T, typename KT, int D>
static int launch_core(const PagedArgs& a, cudaStream_t stream) {
  const size_t smem = tile_smem_bytes<D>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      paged_attention_kernel<T, KT, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const int G = a.H / a.Kv;
  dim3 grid((a.S * G + BQ - 1) / BQ, a.Kv, a.B);
  paged_attention_kernel<T, KT, D><<<grid, NT, smem, stream>>>(
      (const T*)a.q, (const KT*)a.pool, a.table, a.kv_lens, (T*)a.out, a.S, a.H, a.Kv, a.page,
      a.max_pages, a.scale * a.k_scale, a.softcap, a.v_scale);
  return (int)cudaGetLastError();
}

template <int D, typename KT>
static int launch_tc(const PagedArgs& a, cudaStream_t stream) {
  using Gm = hop::Geo<D>;
  constexpr size_t smem = hop::tile_smem<D, KT>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      paged_tc_kernel<D, KT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const int G = a.H / a.Kv;
  CUtensorMap qm, pm;
  int e = hop::tensor_map(&qm, a.q, (uint64_t)a.B * a.S, a.H, D, hop::TQ / G, G, Gm::CW,
                          Gm::SWIZZLE);
  if (!e) {
    if constexpr (sizeof(KT) == 1)  // whole one-byte rows, unswizzled
      e = hop::tensor_map(&pm, a.pool, (uint64_t)a.P * a.page, 2 * a.Kv, D,
                          std::min(a.page, hop::TK), 1, D, CU_TENSOR_MAP_SWIZZLE_NONE,
                          CU_TENSOR_MAP_DATA_TYPE_UINT8);
    else
      e = hop::tensor_map(&pm, a.pool, (uint64_t)a.P * a.page, 2 * a.Kv, D,
                          std::min(a.page, hop::TK), 1, Gm::CW, Gm::SWIZZLE);
  }
  if (e) return e;
  const int pq = hop::TQ / G;  // whole positions per tile
  dim3 grid(a.Kv, a.B, (a.S + pq - 1) / pq);
  paged_tc_kernel<D, KT><<<grid, hop::tile_threads<KT>(), smem, stream>>>(
      qm, pm, a.table, a.kv_lens, (__nv_bfloat16*)a.out, a.S, a.H, a.Kv, a.page, a.max_pages,
      a.scale * a.k_scale, a.softcap, a.v_scale);
  return (int)cudaGetLastError();
}

template <typename T, typename KT, int D>
static int launch(const PagedArgs& a, cudaStream_t stream) {
  const int G = a.H / a.Kv, R = a.S * G;
  if constexpr (sizeof(T) == 2) {
    if (a.n_splits > 0) {  // the split-KV regime: R <= 64, one group of rows
      const kdec::DecodeArgs d{a.q, a.pool, a.table, a.kv_lens, a.out, a.part_o, a.part_ml,
                               a.counters, a.B, a.S, a.H, a.Kv, a.page, a.max_pages,
                               a.n_splits, R, a.scale, a.softcap, a.k_scale, a.v_scale};
      return kdec::launch_split_kv<D, KT>(d, stream);
    }
    // The TMA path takes pages of 8 rows or more that tile 64 keys evenly.
    const bool tma_pages =
        a.page % 8 == 0 && (hop::TK % a.page == 0 || a.page % hop::TK == 0);
    if (R >= hop::TQ && G <= hop::TQ && tma_pages) return launch_tc<D, KT>(a, stream);
  }
  return launch_core<T, KT, D>(a, stream);
}

// dtype: 0 = float32, 1 = bfloat16; kv_code: the pool holds the same type
// (0), int8 (1) or fp8 e4m3 (2), dequantized with k_scale / v_scale; D: 32,
// 64 or 128 (a one-byte pool at 32: the KATTN_ONE_BYTE_D32 build; at 256
// bf16 in the KATTN_D256 build, float32 in the KATTN_F32D256 one). P:
// pages in the pool.
// n_splits > 0 takes bf16's split-KV regime (S*G <= 64): each slot's keys
// in n_splits (1..64) splits, with the wrapper's scratch: part_o
// [B*Kv*n_splits*S*G*D] f32, part_ml [B*Kv*n_splits*S*G] float2, counters
// [B*Kv] int32 (zero, and left zero). n_splits = 0: the prefill tile or
// the CUDA-core tile. Returns a cudaError_t (0 = launched).
extern "C" int paged_attention_launch(const void* q, const void* pool, const void* table,
                                      const void* kv_lens, void* out, void* part_o,
                                      void* part_ml, void* counters, int B, int S, int H,
                                      int Kv, int D, int P, int page, int max_pages,
                                      int n_splits, int dtype, int kv_code, float scale,
                                      float softcap, float k_scale, float v_scale,
                                      void* stream) {
  PagedArgs a{q, pool, (const int*)table, (const int*)kv_lens, out, (float*)part_o,
              (float2*)part_ml, (int*)counters, B, S, H, Kv, P, page, max_pages, n_splits,
              scale, softcap, k_scale, v_scale};
  KATTN_DISPATCH_KV(launch, dtype, kv_code, D, a, (cudaStream_t)stream);
}

template <typename T, typename KT, int D>
static int split_smem(int R, int n_splits) {
  return (int)kdec::split_kv_smem<D, KT>(R, n_splits);
}

// Shared-memory bytes of one block of the split-KV regime at R rows (the
// wrapper refuses launches above the card's per-block limit).
extern "C" int paged_attention_split_smem_bytes(int R, int D, int n_splits, int kv_code) {
  KATTN_DISPATCH_KV(split_smem, 1, kv_code, D, R, n_splits);
}
