// Flash attention for cold prefill (port of the Pallas kernel
// kubeai_tpu/ops/flash_attention.py::_flash_kernel).
//
// Computes causal (or full) GQA attention over contiguous q [B,S,H,D] and
// k/v [B,S,Kv,D], online softmax in float32, key tiles above the diagonal
// skipped. Bound on the H100: at the main path's S=1024, H=32, D=128 the
// causal products are ~8.6 GFLOP against ~20 MB of I/O, so the tensor-core
// rate bounds it (~8.7 us). This first version runs the products on the
// CUDA cores in float32 (no wgmma/TMA yet); its design answers the other
// costs: one block owns 64 query rows of one KV head (16 queries x its G
// query heads), so each K/V tile is read from device memory once for all
// G heads, and tiles past the newest query of the block are never loaded.
#include "attention_common.cuh"

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

template <typename T, int D>
static int launch(const void* q, const void* k, const void* v, void* out,
                  int B, int S, int H, int Kv, int causal, float scale,
                  cudaStream_t stream) {
  const size_t smem = tile_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int G = H / Kv;
  dim3 grid((S * G + BQ - 1) / BQ, Kv, B);
  flash_attention_kernel<T, D><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, S, H, Kv, causal, scale);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16; D: 32, 64 or 128. Returns a
// cudaError_t (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, int B, int S, int H, int Kv,
                                      int D, int causal, int dtype, float scale,
                                      void* stream) {
  KATTN_DISPATCH(launch, dtype, D, q, k, v, out, B, S, H, Kv, causal, scale,
                 (cudaStream_t)stream);
}
