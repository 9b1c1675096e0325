// Flash attention for cold prefill (port of the Pallas kernel
// kubeai_tpu/ops/flash_attention.py::_flash_kernel).
//
// Computes causal (or full) GQA attention over contiguous q [B,S,H,D] and
// k/v [B,S,Kv,D], online softmax in float32, key tiles above the diagonal
// skipped. Bound on the H100: at the main path's S=1024, H=32, D=128 the
// causal products are ~8.6 GFLOP against ~20 MB of I/O, so the tensor-core
// rate bounds it (~8.7 us).
//
// bf16 (the main path) runs the Hopper tile of hopper_attention.cuh: one
// block per 64 (query, head) rows of one KV head, K/V tiles fed by TMA
// through a 2-stage mbarrier ring by a producer warp, both products as
// wgmma with f32 accumulators in registers. Each K/V tile is read once
// for the G heads that share it, tiles past the block's newest query are
// never loaded, and the mask is applied only on tiles that cross the
// diagonal. Blocks are issued heaviest (last query tile) first.
//
// A tile holds 64/G whole positions: with G query heads per KV head not
// dividing 64 (Qwen2.5's 7) it takes G*floor(64/G) rows and pads the
// rest, so every bf16 shape with G <= 64 runs on the tensor cores.
// Head dim 256 (Gemma's) is the same tile at 4 swizzle chunks.
//
// float32 stays on the CUDA-core tile of attention_common.cuh: the card
// tests hold f32 kernels to summation order alone, which the tensor
// cores' TF32 would break, and f32 is not on the main path. So does bf16
// with more than 64 query heads per KV head.
#include "attention_common.cuh"
#include "hopper_attention.cuh"
#include "preload.cuh"

#include <algorithm>

using namespace kattn;

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int S, int H, int Kv, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const size_t base = ((size_t)b * S * Kv + kv) * D;
  ContigSrc<T> src{k + base, v + base, (long long)Kv * D};
  // Causal: query s at position s sees keys <= s. Full: every key < S.
  tile_attention<T, D>(q, out, src, S, H, H / Kv, b, kv, tile,
                       causal ? 0 : S, S, scale, 0.f, smem);
}

// K/V of one (batch, KV head) as TMA boxes of 64 rows over k, v viewed as
// [B*S, Kv, D].
// Rows past S are the next batch's or, past the end, zero-filled by TMA.
template <int D>
struct FlashSrc {
  const CUtensorMap* kmap;
  const CUtensorMap* vmap;
  int row0, kv;
  __device__ __forceinline__ void load(int k0, uint32_t k_dst, uint32_t v_dst,
                                       uint32_t bar) const {
    using Gm = hop::Geo<D>;
#pragma unroll
    for (int c = 0; c < Gm::NCH; ++c) {
      hop::tma_load(k_dst + c * Gm::CHUNK, kmap, bar, c * Gm::CW, kv, row0 + k0);
      hop::tma_load(v_dst + c * Gm::CHUNK, vmap, bar, c * Gm::CW, kv, row0 + k0);
    }
  }
};

template <int D>
__global__ void __launch_bounds__(hop::NTHREADS)
flash_tc_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out,
                int S, int H, int Kv, int causal, float scale) {
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const int kv = blockIdx.x, b = blockIdx.y, tile = gridDim.z - 1 - blockIdx.z;
  FlashSrc<D> src{&kmap, &vmap, b * S, kv};
  hop::TileArgs a{out, S, H, H / Kv, b, kv, tile, causal ? 0 : S, S, scale, 0.f};
  hop::tc_tile<D>(&qmap, src, a, tc_smem);
}

template <typename T, int D>
static int launch_core(const void* q, const void* k, const void* v, void* out, int B, int S,
                       int H, int Kv, int causal, float scale, cudaStream_t stream) {
  const size_t smem = tile_smem_bytes<D>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const int G = H / Kv;
  dim3 grid((S * G + BQ - 1) / BQ, Kv, B);
  flash_attention_kernel<T, D><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, S, H, Kv, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
static int launch_tc(const void* q, const void* k, const void* v, void* out, int B, int S,
                     int H, int Kv, int causal, float scale, cudaStream_t stream) {
  using Gm = hop::Geo<D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Gm::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const int G = H / Kv;
  CUtensorMap qm, km, vm;
  int e = hop::tensor_map(&qm, q, (uint64_t)B * S, H, D, hop::TQ / G, G, Gm::CW, Gm::SWIZZLE);
  if (!e) e = hop::tensor_map(&km, k, (uint64_t)B * S, Kv, D, hop::TK, 1, Gm::CW, Gm::SWIZZLE);
  if (!e) e = hop::tensor_map(&vm, v, (uint64_t)B * S, Kv, D, hop::TK, 1, Gm::CW, Gm::SWIZZLE);
  if (e) return e;
  const int pq = hop::TQ / G;  // whole positions per tile
  dim3 grid(Kv, B, (S + pq - 1) / pq);
  flash_tc_kernel<D><<<grid, hop::NTHREADS, Gm::SMEM, stream>>>(
      qm, km, vm, (__nv_bfloat16*)out, S, H, Kv, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
static int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
                  int Kv, int causal, float scale, cudaStream_t stream) {
  const int G = H / Kv;
  if (sizeof(T) == 2 && G <= hop::TQ)
    return launch_tc<D>(q, k, v, out, B, S, H, Kv, causal, scale, stream);
  return launch_core<T, D>(q, k, v, out, B, S, H, Kv, causal, scale, stream);
}

// dtype: 0 = float32, 1 = bfloat16; D: 32, 64 or 128 (bf16 at 256: the
// KATTN_D256 build). Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, int B, int S, int H, int Kv,
                                      int D, int causal, int dtype, float scale,
                                      void* stream) {
  KATTN_DISPATCH(launch, dtype, D, q, k, v, out, B, S, H, Kv, causal, scale,
                 (cudaStream_t)stream);
}
