// W8A16 matrix product for Hopper: y[M, N] = (x[M, K] @ q) * s with bf16
// x and y, int8 q, a float32 scale per output column, f32 accumulation.
// Port of kubeai_tpu/ops/quant.py::qdot (and ::qmatT), which is no Pallas
// kernel: on the TPU XLA fuses the int8 -> bf16 convert into the dot's
// operand read, so device-memory traffic stays 8-bit. Eager PyTorch has
// no such fusion (x @ q.to(bf16) writes and re-reads a bf16 copy of the
// weight), so the convert happens here, in registers.
//
// Two weight layouts:
//   layout 0: q [K, N], N contiguous, s [1, N] (every projection, the
//             untied lm_head);
//   layout 1: q [N, K], K contiguous, s [N, 1] (qmatT: the tied head over
//             the embedding table).
//
// Bound on the H100. Decode and verify (M <= 64): bytes. Each weight
// byte is read once: Llama-3.1-8B's 7.5 GB of int8 weights take ~2.2 ms
// per step at 3.35 TB/s, against 4.8 ms for the bf16 weights; M <= 64
// rows make at most 128 flops per weight byte, under the ~295 at which
// the tensor cores would bound it. Prefill (M of 1024 and more): the
// tensor cores (2*M*N*K flops at 989 TFLOP/s bf16).
//
// Design, and what each part does about the bound:
// * One kernel, two regimes chosen by M. A block owns 16*MT rows of x
//   and 128 columns of y (32 per warp, four n8 tiles) and walks K in
//   stages of 64. M <= 64 takes MT = ceil(M/16), one row block, so every
//   weight byte is read once per launch; when the column blocks alone
//   cannot fill the card (wk/wv: N = 1024 is 8 blocks), the wrapper
//   splits K over grid.z (split-K) and a second kernel sums the f32
//   partials before it applies the scale. M > 64 takes MT = 4 (64 rows),
//   the row blocks of one column block adjacent in the grid, so a weight
//   tile comes from device memory once and from L2 for the other rows.
// * Copies in flight: a ring of 4 stages of (x tile, weight tile) in
//   shared memory fed by cp.async, 16 bytes a copy (4 where a row stride
//   or base is not 16-byte aligned: N or K off the 16-byte grid), three
//   stages in flight while one is computed; the ragged edges of M, N and
//   K are zero-filled by the copies.
// * Products on the tensor cores: mma.sync m16n8k16 bf16, f32 sums, for
//   both regimes (decode rows past M are zeros: the tensor cores have
//   issue slots to spare at M <= 64). int8 -> bf16 is exact (|q| <= 127)
//   and takes no conversion unit: a byte biased to unsigned is spliced
//   under the exponent of 2^23 (one PRMT), one FADD removes 2^23 + 128,
//   one CVT packs two values into a bf16 pair.
// * No transposes, by relabelling the product's indices. Within a k16
//   step, logical k {2t, 2t+1, 2t+8, 2t+9} of lane t (the mma fragment
//   layout) is physical k {4t .. 4t+3}, for x and q alike, so a lane
//   reads its A fragments as one 8-byte load per row. Layout 1 then has
//   a lane's B fragment in one 4-byte word (q[n][4t .. 4t+3]). Layout 0
//   relabels columns: lane g's word q[k][4g .. 4g+3] holds logical
//   column g of all four n8 tiles, so four words (k = 4t .. 4t+3) feed
//   four tiles; the epilogue maps the accumulators back.
// * Shared memory without bank conflicts: x rows padded to 160 bytes,
//   layout-1 rows to 80, layout-0 rows' 16-byte chunks XOR-swizzled by
//   the row's k group.
#include "split_kv_decode.cuh"

namespace kw8 {

using kattn::i8f;  // byte J of a biased int8 word as a float (PRMT + FADD)
using kattn::pack_bf16;
using kattn::smem_u32;
using kdec::cp_async_commit;
using kdec::cp_async_wait;
using kdec::mma_bf16;

constexpr int NT = 128;            // threads per block: four warps
constexpr int BN = 128;            // columns of y per block, 32 per warp
constexpr int BK = 64;             // K per stage
constexpr int STAGES = 4;
constexpr int XROW = BK * 2 + 32;  // bytes per x row in a stage (padded)
constexpr int KN_ROW = BN;         // layout 0: BK rows of BN bytes (swizzled)
constexpr int NK_ROW = BK + 16;    // layout 1: BN rows of BK bytes (padded)

template <int LAYOUT, int MT>
struct Tile {
  static constexpr int XBYTES = 16 * MT * XROW;
  static constexpr int WBYTES = LAYOUT == 0 ? BK * KN_ROW : BN * NK_ROW;
  static constexpr int STAGE = XBYTES + WBYTES;
  static constexpr int SMEM = STAGES * STAGE;
};

struct Args {
  const __nv_bfloat16* x;  // [M, K]
  const int8_t* q;         // layout 0: [K, N]; layout 1: [N, K]
  const float* s;          // [N]
  __nv_bfloat16* y;        // [M, N]
  float* part;             // [splits, M, N] f32 partials when splits > 1
  int M, N, K, k_split;    // k_split: K per split, a multiple of BK
};

// A copy of VEC (16 or 4) bytes; src_bytes < VEC zero-fills the rest.
template <int VEC>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int src_bytes) {
  if constexpr (VEC == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
                 "r"(src_bytes)
                 : "memory");
}

// Byte offset in a layout-0 stage of byte `off` of row `r`: the row's
// 16-byte chunks XOR 2*((r/4) % 4), so the four k groups that one load
// instruction spans land in distinct banks.
__device__ __forceinline__ int kn_addr(int r, int off) {
  return r * KN_ROW + ((((off >> 4) ^ (((r >> 2) & 3) << 1))) << 4) + (off & 15);
}

template <int LAYOUT, int MT, int VEC>
__global__ void __launch_bounds__(NT) w8a16_kernel(const Args a) {
  using C = Tile<LAYOUT, MT>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int m0 = blockIdx.x * 16 * MT, n0 = blockIdx.y * BN, split = blockIdx.z;
  const int k_lo = split * a.k_split, k_hi = min(a.K, k_lo + a.k_split);
  const int n_steps = (k_hi - k_lo + BK - 1) / BK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const uint32_t base = smem_u32(smem);

  // Stage i: x rows m0.., k0..k0+BK and the matching weight tile.
  auto issue = [&](int i) {
    const uint32_t st = base + (i % STAGES) * C::STAGE;
    const int k0 = k_lo + i * BK;
    constexpr int XCH = BK * 2 / VEC;
    for (int idx = tid; idx < 16 * MT * XCH; idx += NT) {
      const int r = idx / XCH, c = idx - r * XCH, m = m0 + r, k = k0 + c * (VEC / 2);
      const void* src = a.x;
      int n = 0;
      if (m < a.M && k < k_hi) {
        src = a.x + (size_t)m * a.K + k;
        n = min(VEC, (k_hi - k) * 2);
      }
      cp_async<VEC>(st + r * XROW + c * VEC, src, n);
    }
    const uint32_t ws = st + C::XBYTES;
    if constexpr (LAYOUT == 0) {
      constexpr int WCH = BN / VEC;
      for (int idx = tid; idx < BK * WCH; idx += NT) {
        const int r = idx / WCH, c = idx - r * WCH, k = k0 + r, col = n0 + c * VEC;
        const void* src = a.q;
        int n = 0;
        if (k < k_hi && col < a.N) {
          src = a.q + (size_t)k * a.N + col;
          n = min(VEC, a.N - col);
        }
        cp_async<VEC>(ws + kn_addr(r, c * VEC), src, n);
      }
    } else {
      constexpr int WCH = BK / VEC;
      for (int idx = tid; idx < BN * WCH; idx += NT) {
        const int r = idx / WCH, c = idx - r * WCH, row = n0 + r, k = k0 + c * VEC;
        const void* src = a.q;
        int n = 0;
        if (row < a.N && k < k_hi) {
          src = a.q + (size_t)row * a.K + k;
          n = min(VEC, k_hi - k);
        }
        cp_async<VEC>(ws + r * NK_ROW + c * VEC, src, n);
      }
    }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_steps) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of stage i
    __syncthreads();              // everyone's, and stage i-1 is free
    if (i + STAGES - 1 < n_steps) issue(i + STAGES - 1);
    cp_async_commit();
    const unsigned char* xs = smem + (i % STAGES) * C::STAGE;
    const unsigned char* ws = xs + C::XBYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // A: rows g and g+8 of each m16 tile, physical k 4t..4t+3.
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const unsigned char* xr = xs + (mt * 16 + g) * XROW + (kk * 16 + 4 * t4) * 2;
        const uint2 lo = *reinterpret_cast<const uint2*>(xr);
        const uint2 hi = *reinterpret_cast<const uint2*>(xr + 8 * XROW);
        af[mt][0] = lo.x;
        af[mt][1] = hi.x;
        af[mt][2] = lo.y;
        af[mt][3] = hi.y;
      }
      // B: logical column g of n8 tile j, physical k 4t..4t+3.
      uint32_t bf[4][2];
      if constexpr (LAYOUT == 0) {
        uint32_t w[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          w[r] = *reinterpret_cast<const uint32_t*>(
                     ws + kn_addr(kk * 16 + 4 * t4 + r, warp * 32 + 4 * g)) ^
                 0x80808080u;
        bf[0][0] = pack_bf16(i8f<0>(w[0]), i8f<0>(w[1]));
        bf[0][1] = pack_bf16(i8f<0>(w[2]), i8f<0>(w[3]));
        bf[1][0] = pack_bf16(i8f<1>(w[0]), i8f<1>(w[1]));
        bf[1][1] = pack_bf16(i8f<1>(w[2]), i8f<1>(w[3]));
        bf[2][0] = pack_bf16(i8f<2>(w[0]), i8f<2>(w[1]));
        bf[2][1] = pack_bf16(i8f<2>(w[2]), i8f<2>(w[3]));
        bf[3][0] = pack_bf16(i8f<3>(w[0]), i8f<3>(w[1]));
        bf[3][1] = pack_bf16(i8f<3>(w[2]), i8f<3>(w[3]));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t w = *reinterpret_cast<const uint32_t*>(
                                 ws + (warp * 32 + 8 * j + g) * NK_ROW + kk * 16 + 4 * t4) ^
                             0x80808080u;
          bf[j][0] = pack_bf16(i8f<0>(w), i8f<1>(w));
          bf[j][1] = pack_bf16(i8f<2>(w), i8f<3>(w));
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[mt][j], af[mt], bf[j][0], bf[j][1]);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  // Accumulator e of tile j: row g (e < 2) or g+8, logical column 2t +
  // (e & 1), which is physical column 8t + 4(e & 1) + j (layout 0) or
  // 8j + 2t + (e & 1) (layout 1) of the warp's 32.
  const bool direct = gridDim.z == 1;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + mt * 16 + g + 8 * h;
      if (m >= a.M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + warp * 32 + (LAYOUT == 0 ? 8 * t4 + 4 * e + j : 8 * j + 2 * t4 + e);
          if (n >= a.N) continue;
          const float v = acc[mt][j][2 * h + e];
          if (direct)
            a.y[(size_t)m * a.N + n] = __float2bfloat16(v * __ldg(a.s + n));
          else
            a.part[((size_t)split * a.M + m) * a.N + n] = v;
        }
    }
}

// Split-K: y = bf16((sum of the splits' partials) * s), in one pass.
__global__ void __launch_bounds__(256)
w8a16_reduce(const float* __restrict__ part, const float* __restrict__ s,
             __nv_bfloat16* __restrict__ y, int M, int N, int splits) {
  const size_t MN = (size_t)M * N;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < MN;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int z = 0; z < splits; ++z) v += part[z * MN + i];
    y[i] = __float2bfloat16(v * s[i % N]);
  }
}

template <int LAYOUT, int MT, int VEC>
static int launch_tile(const Args& a, int splits, cudaStream_t stream) {
  constexpr int smem = Tile<LAYOUT, MT>::SMEM;
  // Once per instance: every instance needs more than the default 48 KB.
  static const cudaError_t attr = cudaFuncSetAttribute(
      w8a16_kernel<LAYOUT, MT, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((a.M + 16 * MT - 1) / (16 * MT), (a.N + BN - 1) / BN, splits);
  w8a16_kernel<LAYOUT, MT, VEC><<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int LAYOUT, int VEC>
static int launch_rows(const Args& a, int splits, cudaStream_t stream) {
  if (a.M <= 16) return launch_tile<LAYOUT, 1, VEC>(a, splits, stream);
  if (a.M <= 32) return launch_tile<LAYOUT, 2, VEC>(a, splits, stream);
  if (a.M <= 48) return launch_tile<LAYOUT, 3, VEC>(a, splits, stream);
  return launch_tile<LAYOUT, 4, VEC>(a, splits, stream);
}

}  // namespace kw8

// y [M, N] bf16 = (x [M, K] bf16 @ q) * s. layout 0: q [K, N] int8, s
// [N] f32; layout 1: q [N, K]. vec 16 when every base and row stride is
// 16-byte aligned, else 4 (the wrapper refuses less). splits > 1 (M <= 64
// only) cuts K into pieces of k_split (a multiple of 64) and takes part
// [splits, M, N] f32 as scratch. Returns a cudaError_t (0 = launched).
extern "C" int w8a16_launch(const void* x, const void* q, const void* s, void* y, void* part,
                            int M, int N, int K, int layout, int k_split, int splits, int vec,
                            void* stream) {
  using namespace kw8;
  if (M < 1 || N < 1 || K < 1 || splits < 1 || k_split % BK != 0 ||
      (splits > 1 && M > 64) || (layout != 0 && layout != 1) || (vec != 16 && vec != 4))
    return (int)cudaErrorInvalidValue;
  const Args a{(const __nv_bfloat16*)x, (const int8_t*)q, (const float*)s, (__nv_bfloat16*)y,
               (float*)part, M, N, K, k_split};
  const cudaStream_t st = (cudaStream_t)stream;
  int err;
  if (layout == 0)
    err = vec == 16 ? launch_rows<0, 16>(a, splits, st) : launch_rows<0, 4>(a, splits, st);
  else
    err = vec == 16 ? launch_rows<1, 16>(a, splits, st) : launch_rows<1, 4>(a, splits, st);
  if (err != 0 || splits == 1) return err;
  const long long tiles = ((long long)M * N + 255) / 256;
  const int blocks = (int)(tiles < 1024 ? tiles : 1024);
  w8a16_reduce<<<blocks, 256, 0, st>>>((const float*)part, (const float*)s, (__nv_bfloat16*)y,
                                       M, N, splits);
  return (int)cudaGetLastError();
}
