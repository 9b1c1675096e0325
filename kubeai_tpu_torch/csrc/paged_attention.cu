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
// Bound on the H100: memory for decode and short prefill (a decode step
// at B=8, kv_len=512 reads ~16.8 MB per layer call: ~5 us at 3.35 TB/s),
// tensor-core rate for 1024-token chunks. Design: the flash kernel's tile
// core (attention_common.cuh) with keys looked up through the page table:
// one block owns 64 (query, head) rows of one KV head, so each page is
// read once for the G heads that share it and never copied into a
// gathered view; the walk stops at the newest query of the block. A
// decode step fills 4 of the 64 rows; the block skips the empty rows'
// arithmetic, and the dedicated decode kernel is the S=1 design.
#include "attention_common.cuh"

using namespace kattn;

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

template <typename T, int D>
static int launch(const void* q, const void* pool, const int* table, const int* kv_lens,
                  void* out, int B, int S, int H, int Kv, int page, int max_pages,
                  float scale, float softcap, cudaStream_t stream) {
  const size_t smem = tile_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(paged_attention_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int G = H / Kv;
  dim3 grid((S * G + BQ - 1) / BQ, Kv, B);
  paged_attention_kernel<T, D><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)pool, table, kv_lens, (T*)out, S, H, Kv, page,
      max_pages, scale, softcap);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16; D: 32, 64 or 128. Returns a
// cudaError_t (0 = launched).
extern "C" int paged_attention_launch(const void* q, const void* pool, const void* table,
                                      const void* kv_lens, void* out, int B, int S,
                                      int H, int Kv, int D, int page, int max_pages,
                                      int dtype, float scale, float softcap,
                                      void* stream) {
  KATTN_DISPATCH(launch, dtype, D, q, pool, (const int*)table, (const int*)kv_lens, out, B,
                 S, H, Kv, page, max_pages, scale, softcap, (cudaStream_t)stream);
}
