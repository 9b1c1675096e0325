// W8A16 matrix product for Hopper: y[M, N] = (x[M, K] @ q) * s with bf16
// x and y, int8 q, a float32 scale per output column, f32 accumulation
// (and a float32 instance: float32 x and y). Port of
// kubeai_tpu/ops/quant.py::qdot (and ::qmatT), which is no Pallas kernel:
// on the TPU XLA fuses the int8 -> bf16 convert into the dot's operand
// read, so device-memory traffic stays 8-bit. Eager PyTorch has no such
// fusion (x @ q.to(bf16) writes and re-reads a bf16 copy of the weight),
// so the convert happens here, on the card, once per weight byte.
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
// The wrapper (ops/quant.py::regime) picks one of three kernels by M:
// * Decode (M <= 16, and rows whose weight or x is off TMA's 16-byte
//   grid): w8a16_mma_kernel streams the weight. A block owns 16*MT rows
//   of x and 128 columns of y (32 per warp, four n8 tiles) and walks K in
//   stages of 64 through a ring of 4 stages of (x tile, weight tile) fed
//   by cp.async, 16 bytes a copy (4 where a row stride or base is not
//   16-byte aligned), the ragged edges zero-filled by the copies. The
//   products are mma.sync m16n8k16 bf16 with f32 sums: at 8 rows the
//   bytes bound it and the tensor cores have issue slots to spare.
//   int8 -> bf16 is exact (|q| <= 127) and takes no conversion unit: a
//   byte biased to unsigned is spliced under the exponent of 2^23 (one
//   PRMT), one FADD removes 2^23 + 128, one CVT packs two values into a
//   bf16 pair. No transposes, by relabelling the product's indices:
//   within a k16 step, logical k {2t, 2t+1, 2t+8, 2t+9} of lane t is
//   physical k {4t .. 4t+3}, for x and q alike, so a lane reads its A
//   fragments as one 8-byte load per row; layout 1 then has a lane's B
//   fragment in one 4-byte word, layout 0 relabels columns (lane g's
//   word q[k][4g .. 4g+3] holds logical column g of all four n8 tiles).
//   Shared memory without bank conflicts: x rows padded to 160 bytes,
//   layout-1 rows to 80, layout-0 rows' 16-byte chunks XOR-swizzled.
// * Verify and prefill (16 < M, weight and x on TMA's grid):
//   w8a16_wgmma_kernel, a warp-specialized tensor-core tile. One producer
//   warpgroup and NC consumer warpgroups of 64 rows each (NC = 1 up to
//   M = 64, BN = 64 columns; else NC = 2, BN = 256, or 128 where 256
//   would leave half the SMs idle: each widened weight tile then feeds
//   128 rows, and x is read from L2 once per 256 columns). The producer's first
//   thread keeps a ring of one-byte weight tiles ([64 k, BN] or [BN, 64
//   k]) in flight by TMA and the x tiles ([BM, 64] bf16, 128-byte
//   swizzled) a few steps ahead, all zero-filled past M, N and K; all 128
//   producer threads widen each weight tile once, exactly (widen4_bf16:
//   PRMT, two LOP3 and a bf16x2 subtraction for four bytes), into a bf16
//   stage in the 128-byte swizzle that the wgmma descriptors name (layout
//   0's B is N-major: the descriptor's transpose bit; layout 1's is
//   K-major), fence the generic-proxy writes for the async proxy
//   (fence.proxy.async) and arrive on the stage's "full" barrier. The
//   consumers run wgmma m64nBNk16 (A and B from shared memory, f32 sums
//   in registers) and keep one product group in flight while they free
//   the stages of the one before.
// * float32 activations (off the serving path: the JAX package's float32
//   test configuration): w8a16_f32_kernel, 64 x 64 tiles of FFMA on the
//   CUDA cores, the int8 values converted exactly to float32.
// Registers: every instance fits its block's budget without spills
// (chip_smoke.py phase 1 checks), so no setmaxnreg (its .inc would wait
// forever for registers that a smaller compiled count never released).
// Measured on the H100 (PERF.md): taking away the widening, the
// products or both from the wgmma tile showed that its loads alone (x
// read from L2 once per column block) set most of its time at M = 1024,
// and that the three do not overlap fully. Swapping the operands (the
// weight widened into register A fragments, x the shared-memory B) was
// faster only at two consumer warpgroups, whose 192 live registers spill
// at the 168 a 3-warpgroup block allows; at one warpgroup it was slower,
// so it was not kept.
//
// Grid. One launch serves up to three weights that share x (the wrapper's
// qdot_many: wq|wk|wv, wg|wu), each with its own pointers, shape and
// split plan: blockIdx.x walks the weights' blocks in turn, and within a
// weight the row blocks of one column block stay adjacent, so a weight
// tile comes from device memory once and from L2 for the other rows.
// Every output is bit-identical to a launch of its weight alone.
//
// Split-K (M <= 64, when the column blocks alone cannot fill the card):
// K is cut into pieces of k_split (a multiple of 64); each split writes
// its f32 partial tile, fences (__threadfence) and bumps the output
// tile's arrival counter (atomicAdd). The last block to arrive sums the
// partials in split order 0..S-1 (so the result does not depend on which
// block came last), applies the scale, writes y and resets the counter to
// zero for the next launch: one launch per call, no atomics on y. The
// partials and counters are the wrapper's workspace, per (device,
// stream), grown before use; the counters are zeroed once and every
// launch leaves them zero, which holds for launches in stream order. A
// CUDA graph that captures these launches must size the workspace before
// capture (ops/quant.py::reserve_workspace): growing it inside a capture
// would allocate.
#include <mutex>
#include <unordered_map>

#include "hopper_attention.cuh"
#include "split_kv_decode.cuh"

namespace kw8 {

using kattn::i8f;  // byte J of a biased int8 word as a float (PRMT + FADD)
using kattn::pack_bf16;
using kattn::smem_u32;
using kdec::cp_async_commit;
using kdec::cp_async_wait;
using kdec::mma_bf16;
using kdec::named_sync;
typedef __nv_bfloat16 bf16;

constexpr int NT = 128;            // threads per block of the mma.sync kernel: four warps
constexpr int BN = 128;            // columns of y per block, 32 per warp
constexpr int BK = 64;             // K per stage (every kernel)
constexpr int STAGES = 4;
constexpr int XROW = BK * 2 + 32;  // bytes per x row in a stage (padded)
constexpr int KN_ROW = BN;         // layout 0: BK rows of BN bytes (swizzled)
constexpr int NK_ROW = BK + 16;    // layout 1: BN rows of BK bytes (padded)
constexpr int MAXW = 3;            // weights per launch
constexpr int FT = 64;             // float32 kernel: rows and columns of a block
constexpr int FK = 32;             // and K per step

template <int LAYOUT, int MT>
struct Tile {
  static constexpr int XBYTES = 16 * MT * XROW;
  static constexpr int WBYTES = LAYOUT == 0 ? BK * KN_ROW : BN * NK_ROW;
  static constexpr int STAGE = XBYTES + WBYTES;
  static constexpr int SMEM = STAGES * STAGE;
};

// One weight of a launch.
struct Wt {
  const int8_t* q;  // layout 0: [K, N]; layout 1: [N, K]
  const float* s;   // [N]
  void* y;          // [M, N], x's dtype
  float* part;      // [splits, M, N] f32 partials when splits > 1
  int* counters;    // [cb * rb] arrival counters when splits > 1 (zero; left zero)
  int N, k_split, splits, cb, blocks;  // cb: column blocks; blocks: rb * cb * splits
};

struct Args {
  const void* x;  // [M, K]
  int M, K, rb, nw;  // rb: row blocks
  Wt w[MAXW];
};

struct Where {
  int wi, rb, cb, sp;
};

// The weight, row block, column block and split of this block.
__device__ __forceinline__ Where locate(const Args& a) {
  int b = blockIdx.x, wi = 0;
  while (wi + 1 < a.nw && b >= a.w[wi].blocks) b -= a.w[wi++].blocks;
  const int splits = a.w[wi].splits;
  Where r;
  r.wi = wi;
  r.rb = b % a.rb;
  b /= a.rb;
  r.sp = b % splits;
  r.cb = b / splits;
  return r;
}

// The split-K epilogue after a block wrote its partial tile: the last of
// the tile's splits to arrive reduces. NTH threads (ids 0..NTH-1) take
// part, synchronized by named barrier BAR. The reduction reads the
// splits' partials from L2 with 16-byte loads, BATCH splits' loads in
// flight before their sums (in split order), so it costs one or two L2
// round trips a unit, not one per split: it is the launch's tail. BATCH
// trades that tail against registers (4 per split), which bound the
// blocks an SM holds.
template <int NTH, int BAR, int BATCH>
__device__ __forceinline__ void split_finish(const Wt& w, int M, int m0, int bm, int n0, int bn,
                                             int tile, int tid) {
  __shared__ int last;
  __threadfence();  // this thread's partials are visible to the card before the count
  named_sync<BAR, NTH>();
  if (tid == 0) last = atomicAdd(w.counters + tile, 1) == w.splits - 1;
  named_sync<BAR, NTH>();
  if (!last) return;
  __threadfence();
  const int rows = min(bm, M - m0), cols = min(bn, w.N - n0);
  bf16* y = static_cast<bf16*>(w.y);
  const size_t plane = (size_t)M * w.N;
  // Four columns a unit where N allows (then every unit is 16-byte
  // aligned: the wrapper aligns each weight's partials to 16 bytes).
  const int vw = (w.N & 3) == 0 ? 4 : 1, cu = (cols + vw - 1) / vw;
  for (int i = tid; i < rows * cu; i += NTH) {
    const int r = i / cu, c = (i - r * cu) * vw;
    const size_t o = (size_t)(m0 + r) * w.N + n0 + c;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    for (int z0 = 0; z0 < w.splits; z0 += BATCH) {
      float4 p[BATCH];
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const float* src = w.part + (z0 + j) * plane + o;
        if (z0 + j >= w.splits) p[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        else if (vw == 4) p[j] = __ldcg(reinterpret_cast<const float4*>(src));
        else p[j] = make_float4(__ldcg(src), 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        if (z0 + j >= w.splits) break;
        v[0] += p[j].x;
        v[1] += p[j].y;
        v[2] += p[j].z;
        v[3] += p[j].w;
      }
    }
    for (int e = 0; e < vw; ++e) y[o + e] = __float2bfloat16(v[e] * __ldg(w.s + n0 + c + e));
  }
  if (tid == 0) w.counters[tile] = 0;
}

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

// ---------------------------------------------------------------------------
// Decode: mma.sync, weight-streaming.

// At one row tile (decode) five blocks fit an SM's shared memory; the
// launch bound keeps their registers within it too, the split-K tail's
// sixteen loads in flight included.
template <int LAYOUT, int MT, int VEC>
__global__ void __launch_bounds__(NT, MT == 1 ? 5 : 1) w8a16_mma_kernel(const Args a) {
  using C = Tile<LAYOUT, MT>;
  extern __shared__ __align__(16) unsigned char smem[];
  const Where at = locate(a);
  const Wt w = a.w[at.wi];  // by value: registers, not indexed param loads
  const bf16* __restrict__ x = static_cast<const bf16*>(a.x);
  const int8_t* __restrict__ q = w.q;
  const int M = a.M, N = w.N, K = a.K;
  const int m0 = at.rb * 16 * MT, n0 = at.cb * BN, split = at.sp;
  const int k_lo = split * w.k_split, k_hi = min(K, k_lo + w.k_split);
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
      const void* src = x;
      int n = 0;
      if (m < M && k < k_hi) {
        src = x + (size_t)m * K + k;
        n = min(VEC, (k_hi - k) * 2);
      }
      cp_async<VEC>(st + r * XROW + c * VEC, src, n);
    }
    const uint32_t ws = st + C::XBYTES;
    if constexpr (LAYOUT == 0) {
      constexpr int WCH = BN / VEC;
      for (int idx = tid; idx < BK * WCH; idx += NT) {
        const int r = idx / WCH, c = idx - r * WCH, k = k0 + r, col = n0 + c * VEC;
        const void* src = q;
        int n = 0;
        if (k < k_hi && col < N) {
          src = q + (size_t)k * N + col;
          n = min(VEC, N - col);
        }
        cp_async<VEC>(ws + kn_addr(r, c * VEC), src, n);
      }
    } else {
      constexpr int WCH = BK / VEC;
      for (int idx = tid; idx < BN * WCH; idx += NT) {
        const int r = idx / WCH, c = idx - r * WCH, row = n0 + r, k = k0 + c * VEC;
        const void* src = q;
        int n = 0;
        if (row < N && k < k_hi) {
          src = q + (size_t)row * K + k;
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
        uint32_t wd[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          wd[r] = *reinterpret_cast<const uint32_t*>(
                      ws + kn_addr(kk * 16 + 4 * t4 + r, warp * 32 + 4 * g)) ^
                  0x80808080u;
        bf[0][0] = pack_bf16(i8f<0>(wd[0]), i8f<0>(wd[1]));
        bf[0][1] = pack_bf16(i8f<0>(wd[2]), i8f<0>(wd[3]));
        bf[1][0] = pack_bf16(i8f<1>(wd[0]), i8f<1>(wd[1]));
        bf[1][1] = pack_bf16(i8f<1>(wd[2]), i8f<1>(wd[3]));
        bf[2][0] = pack_bf16(i8f<2>(wd[0]), i8f<2>(wd[1]));
        bf[2][1] = pack_bf16(i8f<2>(wd[2]), i8f<2>(wd[3]));
        bf[3][0] = pack_bf16(i8f<3>(wd[0]), i8f<3>(wd[1]));
        bf[3][1] = pack_bf16(i8f<3>(wd[2]), i8f<3>(wd[3]));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t wd = *reinterpret_cast<const uint32_t*>(
                                  ws + (warp * 32 + 8 * j + g) * NK_ROW + kk * 16 + 4 * t4) ^
                              0x80808080u;
          bf[j][0] = pack_bf16(i8f<0>(wd), i8f<1>(wd));
          bf[j][1] = pack_bf16(i8f<2>(wd), i8f<3>(wd));
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
  const bool direct = w.splits == 1;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + mt * 16 + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + warp * 32 + (LAYOUT == 0 ? 8 * t4 + 4 * e + j : 8 * j + 2 * t4 + e);
          if (n >= N) continue;
          const float v = acc[mt][j][2 * h + e];
          if (direct)
            static_cast<bf16*>(w.y)[(size_t)m * N + n] = __float2bfloat16(v * __ldg(w.s + n));
          else
            w.part[((size_t)split * M + m) * N + n] = v;
        }
    }
  if (!direct) split_finish<NT, 1, 16>(w, M, m0, 16 * MT, n0, BN, at.cb * a.rb + at.rb, tid);
}

// ---------------------------------------------------------------------------
// Verify and prefill: wgmma fed by TMA, one producer warpgroup widening.

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_m64n64_tb(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_m64n128_tb(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}


__device__ __forceinline__ void wgmma_ss_m64n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_m64n256_tb(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}


// Four int8 (one word, element 0 in the low byte) as four bf16 (two
// words), exactly, in eight instructions: each byte goes to the low byte
// of a 16-bit half (PRMT); 0x4300 | (b & 0x7f) is the bf16 128 + l, and
// 0x4300 | (b & 0x80) the bf16 128 or 256 by the sign bit, so their
// difference (one bf16x2 subtraction, exact on these integers) is l -
// 128 s, the byte's two's-complement value.
__device__ __forceinline__ uint2 widen4_bf16(uint32_t w) {
  uint2 r;
  const uint32_t lo = __byte_perm(w, 0, 0x4140), hi = __byte_perm(w, 0, 0x4342);
  asm("{\n.reg .b32 v, c;\n"
      "lop3.b32 v, %2, %4, %6, 0xea;\n"  // (a & b) | c
      "lop3.b32 c, %2, %5, %6, 0xea;\n"
      "sub.rn.bf16x2 %0, v, c;\n"
      "lop3.b32 v, %3, %4, %6, 0xea;\n"
      "lop3.b32 c, %3, %5, %6, 0xea;\n"
      "sub.rn.bf16x2 %1, v, c;\n}\n"
      : "=r"(r.x), "=r"(r.y)
      : "r"(lo), "r"(hi), "r"(0x007f007fu), "r"(0x00800080u), "r"(0x43004300u));
  return r;
}

// Widens a one-byte tile [ROWS][D] (unswizzled, as TMA leaves it) into
// the bf16 layout the wgmma descriptors read: chunks of 64 columns
// ROWS*128 bytes apart, each row's 16-byte units XOR the row's address
// bits 7-9 (the 128-byte swizzle). 128 threads, 16 bytes in at a time.
template <int ROWS, int D>
__device__ __forceinline__ void widen(const unsigned char* in, unsigned char* dst, int t) {
  constexpr int CHUNK = ROWS * 128;
#pragma unroll 4
  for (int u = t; u < ROWS * D / 16; u += 128) {
    const int j = u / (D / 16), col = (u - j * (D / 16)) * 16;
    const uint4 b = *reinterpret_cast<const uint4*>(in + j * D + col);
    const uint2 w0 = widen4_bf16(b.x), w1 = widen4_bf16(b.y);
    const uint2 w2 = widen4_bf16(b.z), w3 = widen4_bf16(b.w);
    const uint4 out[2] = {make_uint4(w0.x, w0.y, w1.x, w1.y), make_uint4(w2.x, w2.y, w3.x, w3.y)};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = col + 8 * h;  // first of 8 columns
      const int a = j * 128 + (c % 64) * 2;
      *reinterpret_cast<uint4*>(dst + (c / 64) * CHUNK + (a ^ (((a >> 7) & 7) << 4))) = out[h];
    }
  }
}

// The products of one k16 step: m64 x WBN, B N-major (layout 0, the
// transpose bit) or K-major (layout 1).
template <int LAYOUT, int WBN>
__device__ __forceinline__ void wgmma_step(float (&d)[WBN / 2], uint64_t da, uint64_t db) {
  if constexpr (WBN == 256) {
    if constexpr (LAYOUT == 0) wgmma_ss_m64n256_tb(d, da, db);
    else wgmma_ss_m64n256(d, da, db);
  } else if constexpr (WBN == 128) {
    if constexpr (LAYOUT == 0) wgmma_ss_m64n128_tb(d, da, db);
    else wgmma_ss_m64n128(d, da, db);
  } else {
    if constexpr (LAYOUT == 0) wgmma_ss_m64n64_tb(d, da, db);
    else wgmma_ss_m64n64(d, da, db);
  }
}

template <int NC, int WBN>
struct Wg {
  static constexpr int BM = 64 * NC;                // rows of y per block
  static constexpr int SB = NC == 1 ? 2 : 3;        // widened bf16 stages
  static constexpr int SX = NC == 2 && WBN == 256 ? 5 : 4;  // x stages
  static constexpr int S8 = WBN == 256 ? 3 : 4;     // one-byte weight stages
  static constexpr int XL = SX - SB;                // x tiles issued ahead of the producer
  static constexpr int XST = BM * BK * 2;           // an x stage: BM rows of 128 bytes
  static constexpr int W8 = BK * WBN;               // a one-byte weight tile
  static constexpr int WB = BK * WBN * 2;           // its bf16 stage
  static constexpr int W8_OFF = SX * XST;
  static constexpr int WB_OFF = W8_OFF + S8 * W8;
  static constexpr int BAR_OFF = WB_OFF + SB * WB;
  static constexpr int SMEM = BAR_OFF + 8 * (S8 + 2 * SB + SX) + 1024;  // + slack for a 1 KB base
  static constexpr int THREADS = 128 * (NC + 1);
  static_assert(XL >= 1, "x stages must outnumber the bf16 stages");
  static_assert(SMEM <= 232448, "the card's shared memory per block");
};

struct Maps {
  CUtensorMap x;        // x's bf16 tiles [BM rows, 64], 128-byte swizzled
  CUtensorMap m[MAXW];  // each weight's one-byte tiles
};

// The consumer warpgroups of the wgmma tile: products, then y (or the
// split's partial tile).
template <int LAYOUT, int NC, int WBN>
__device__ __forceinline__ void consume(const Args& a, const Wt& w, const Where& at, uint32_t base,
                                        int m0, int n0, int n_steps) {
  using C = Wg<NC, WBN>;
  const int M = a.M, N = w.N;
  const uint32_t bars = base + C::BAR_OFF;
  auto full = [&](int s) { return bars + 8u * (C::S8 + s); };
  auto empty = [&](int s) { return bars + 8u * (C::S8 + C::SB + s); };
  auto xland = [&](int s) { return bars + 8u * (C::S8 + 2 * C::SB + s); };
  // Consumer warpgroup cw: rows m0 + 64*cw .. +63, at 8 KB into each x stage.
  const int cw = threadIdx.x >> 7, ct = threadIdx.x & 127;
  const int mrow0 = m0 + cw * 64;
  float acc[WBN / 2];
#pragma unroll
  for (int i = 0; i < WBN / 2; ++i) acc[i] = 0.f;
  for (int t = 0; t < n_steps; ++t) {
    hop::mbar_wait(xland(t % C::SX), (t / C::SX) & 1);
    hop::mbar_wait(full(t % C::SB), (t / C::SB) & 1);
    const uint32_t xs = base + (t % C::SX) * C::XST + cw * 64 * 128;
    const uint32_t wb = base + C::WB_OFF + (t % C::SB) * C::WB;
    hop::fence_regs(acc);
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // A: 64 rows of 128 bytes, K-major; a k16 step moves 32 bytes.
      const uint64_t da = hop::make_desc(xs + kk * 32, 16, 1024, 1);
      // B, layout 0: 16 k-rows of WBN columns in 64-column chunks 8 KB
      // apart (LBO), 8-row groups 1 KB apart (SBO). Layout 1: WBN n-rows
      // of 128 bytes, K-major like A.
      const uint64_t db = LAYOUT == 0 ? hop::make_desc(wb + kk * 16 * 128, 64 * 128, 1024, 1)
                                      : hop::make_desc(wb + kk * 32, 16, 1024, 1);
      wgmma_step<LAYOUT, WBN>(acc, da, db);
    }
    hop::wgmma_commit();
    wgmma_wait<1>();  // tile t-1's products are done: free its x and bf16 stages
    hop::fence_regs(acc);
    if (t > 0) hop::mbar_arrive(empty((t - 1) % C::SB));
  }
  wgmma_wait<0>();
  hop::fence_regs(acc);

  // Sum j*4 + 2h + e: row 16*warp + lane/4 + 8h, column 8j + 2(lane%4) + e.
  const int warp = ct >> 5, lane = ct & 31;
  const bool direct = w.splits == 1, even = (N & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = mrow0 + warp * 16 + (lane >> 2) + 8 * h;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < WBN / 8; ++j) {
      const int n = n0 + j * 8 + (lane & 3) * 2;
      if (n >= N) continue;
      const float v0 = acc[j * 4 + 2 * h], v1 = acc[j * 4 + 2 * h + 1];
      const bool pair = n + 1 < N;
      if (direct) {
        bf16* y = static_cast<bf16*>(w.y) + (size_t)m * N + n;
        const float s0 = __ldg(w.s + n), s1 = pair ? __ldg(w.s + n + 1) : 0.f;
        if (even) {
          *reinterpret_cast<__nv_bfloat162*>(y) = __floats2bfloat162_rn(v0 * s0, v1 * s1);
        } else {
          y[0] = __float2bfloat16(v0 * s0);
          if (pair) y[1] = __float2bfloat16(v1 * s1);
        }
      } else {
        float* p = w.part + ((size_t)at.sp * M + m) * N + n;
        if (even) {
          *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
        } else {
          p[0] = v0;
          if (pair) p[1] = v1;
        }
      }
    }
  }
}


template <int LAYOUT, int NC, int WBN>
__global__ void __launch_bounds__(Wg<NC, WBN>::THREADS, 1)
w8a16_wgmma_kernel(const __grid_constant__ Maps maps, const Args a) {
  using C = Wg<NC, WBN>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the 128-byte swizzle repeats every 1 KB
  unsigned char* const gbase = smem_raw + (base - raw);
  const uint32_t bars = base + C::BAR_OFF;
  auto landed = [&](int s) { return bars + 8u * s; };                // one-byte tile arrived
  auto full = [&](int s) { return bars + 8u * (C::S8 + s); };        // bf16 stage widened
  auto empty = [&](int s) { return bars + 8u * (C::S8 + C::SB + s); };  // tile consumed
  auto xland = [&](int s) { return bars + 8u * (C::S8 + 2 * C::SB + s); };  // x tile arrived

  const Where at = locate(a);
  const Wt w = a.w[at.wi];  // by value: registers, not indexed param loads
  const int M = a.M, K = a.K;
  const int m0 = at.rb * C::BM, n0 = at.cb * WBN;
  const int k_lo = at.sp * w.k_split, k_hi = min(K, k_lo + w.k_split);
  const int n_steps = (k_hi - k_lo + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::S8; ++s) hop::mbar_init(landed(s), 1);
    for (int s = 0; s < C::SX; ++s) hop::mbar_init(xland(s), 1);
    for (int s = 0; s < C::SB; ++s) {
      hop::mbar_init(full(s), 128);
      hop::mbar_init(empty(s), 128 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * NC) {
    // Producer warpgroup: its first thread keeps S8 one-byte tiles in
    // flight and the x tiles XL ahead; all 128 wait for tile t and for
    // the consumers to free bf16 stage t % SB (tile t - SB done: x stage
    // (t + XL) % SX is free too, and the first thread refills it), widen,
    // fence, arrive on "full", meet, and the first thread refills the
    // one-byte stage with tile t + S8.
    const int pt = threadIdx.x - 128 * NC;
    const CUtensorMap* map = at.wi == 0 ? &maps.m[0] : at.wi == 1 ? &maps.m[1] : &maps.m[2];
    auto issue = [&](int t) {
      const int st = t % C::S8;
      hop::mbar_expect_tx(landed(st), C::W8);
      const int k = k_lo + t * BK;
      if constexpr (LAYOUT == 0)
        tma_load_2d(base + C::W8_OFF + st * C::W8, map, landed(st), n0, k);
      else
        tma_load_2d(base + C::W8_OFF + st * C::W8, map, landed(st), k, n0);
    };
    auto issue_x = [&](int t) {
      const int st = t % C::SX;
      hop::mbar_expect_tx(xland(st), C::XST);
      tma_load_2d(base + st * C::XST, &maps.x, xland(st), k_lo + t * BK, m0);
    };
    if (pt == 0) {
      for (int t = 0; t < C::XL && t < n_steps; ++t) issue_x(t);
      for (int t = 0; t < C::S8 && t < n_steps; ++t) issue(t);
    }
    for (int t = 0; t < n_steps; ++t) {
      const int st = t % C::S8, sb = t % C::SB;
      hop::mbar_wait(landed(st), (t / C::S8) & 1);
      hop::mbar_wait(empty(sb), ((t / C::SB) & 1) ^ 1);
      if (pt == 0 && t + C::XL < n_steps) issue_x(t + C::XL);
      const unsigned char* in = gbase + C::W8_OFF + st * C::W8;
      unsigned char* out = gbase + C::WB_OFF + sb * C::WB;
      if constexpr (LAYOUT == 0)
        widen<BK, WBN>(in, out, pt);  // [64 k][WBN n]
      else
        widen<WBN, BK>(in, out, pt);  // [WBN n][64 k]
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      hop::mbar_arrive(full(sb));
      named_sync<1, 128>();  // one-byte stage st read by all
      if (pt == 0 && t + C::S8 < n_steps) issue(t + C::S8);
    }
  } else {
    consume<LAYOUT, NC, WBN>(a, w, at, base, m0, n0, n_steps);
  }
  // Split-K: every thread of the block (the producers too) helps reduce.
  if (w.splits > 1)
    split_finish<C::THREADS, 4, 8>(w, M, m0, C::BM, n0, WBN, at.cb * a.rb + at.rb, threadIdx.x);
}

// ---------------------------------------------------------------------------
// float32 activations: FFMA on the CUDA cores.

template <int LAYOUT>
__global__ void __launch_bounds__(256) w8a16_f32_kernel(const Args a) {
  __shared__ float xs[FK][FT + 1];  // [k][row]
  __shared__ float ws[FK][FT + 1];  // [k][column]
  const Where at = locate(a);
  const Wt w = a.w[at.wi];  // by value: registers, not indexed param loads
  const float* __restrict__ x = static_cast<const float*>(a.x);
  const int8_t* __restrict__ q = w.q;
  const int M = a.M, K = a.K, N = w.N, m0 = at.rb * FT, n0 = at.cb * FT;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += FK) {
    for (int i = tid; i < FT * FK; i += 256) {
      const int r = i / FK, k = i % FK;
      xs[k][r] = m0 + r < M && k0 + k < K ? x[(size_t)(m0 + r) * K + k0 + k] : 0.f;
      if constexpr (LAYOUT == 0) {
        const int kk = i / FT, n = i % FT;
        ws[kk][n] = k0 + kk < K && n0 + n < N ? (float)q[(size_t)(k0 + kk) * N + n0 + n] : 0.f;
      } else {
        ws[k][r] = n0 + r < N && k0 + k < K ? (float)q[(size_t)(n0 + r) * K + k0 + k] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < FK; ++k) {
      float xv[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        xv[i] = xs[k][ty + 16 * i];
        wv[i] = ws[k][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* y = static_cast<float*>(w.y);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) y[(size_t)m * N + n] = acc[i][j] * __ldg(w.s + n);
    }
  }
}

// ---------------------------------------------------------------------------
// Host.

// Tensor maps of the weights' one-byte tiles, cached by (pointer, shape,
// box). A model's step names ~225 per-layer weight views, so the cache is
// the W8A16 kernel's own and holds thousands, found by hash.
struct MapKey {
  const void* p;
  uint64_t inner, rows;
  uint32_t box_inner, box_rows;
  bool operator==(const MapKey& o) const {
    return p == o.p && inner == o.inner && rows == o.rows && box_inner == o.box_inner &&
           box_rows == o.box_rows;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    size_t h = std::hash<const void*>()(k.p);
    h ^= std::hash<uint64_t>()(k.inner * 1000003u + k.rows) + 0x9e3779b97f4a7c15ull + (h << 6);
    return h ^ (k.box_inner * 131u + k.box_rows);
  }
};

// The map of a one-byte [rows, inner] matrix (inner contiguous, a
// multiple of 16 bytes) in boxes of [box_rows, box_inner], unswizzled,
// zero-filled out of bounds. Returns a cudaError_t.
static int weight_map(CUtensorMap* out, const void* p, uint64_t inner, uint64_t rows,
                      uint32_t box_inner, uint32_t box_rows) {
  static std::mutex mu;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> cache;
  const MapKey key{p, inner, rows, box_inner, box_rows};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *out = it->second;
    return 0;
  }
  hop::EncodeTiledFn enc = hop::encoder();
  if (!enc) return (int)cudaErrorNotSupported;
  cuuint64_t dims[2] = {inner, rows};
  cuuint64_t strides[1] = {inner};
  cuuint32_t box[2] = {box_inner, box_rows};
  cuuint32_t estr[2] = {1, 1};
  if (enc(out, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(p), dims, strides, box, estr,
          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
          CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  if (cache.size() >= 8192) cache.clear();
  cache.emplace(key, *out);
  return 0;
}

// The map of x [M, K] bf16 (rows 16-byte aligned) in boxes of [bm rows,
// 64], 128-byte swizzled (the wgmma A descriptors' layout), zero-filled
// past M and K; cached like the weights' (a serving step's activations
// come back to the same few addresses).
static int x_map(CUtensorMap* out, const void* x, int K, int M, int bm) {
  static std::mutex mu;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> cache;
  const MapKey key{x, (uint64_t)K, (uint64_t)M, BK, (uint32_t)bm};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *out = it->second;
    return 0;
  }
  hop::EncodeTiledFn enc = hop::encoder();
  if (!enc) return (int)cudaErrorNotSupported;
  cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  cuuint32_t box[2] = {BK, (cuuint32_t)bm};
  cuuint32_t estr[2] = {1, 1};
  if (enc(out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), dims, strides, box,
          estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  if (cache.size() >= 8192) cache.clear();
  cache.emplace(key, *out);
  return 0;
}

template <int LAYOUT, int MT, int VEC>
static int launch_mma(const Args& a, int blocks, cudaStream_t stream) {
  constexpr int smem = Tile<LAYOUT, MT>::SMEM;
  // Once per instance: every instance needs more than the default 48 KB.
  static const cudaError_t attr = cudaFuncSetAttribute(
      w8a16_mma_kernel<LAYOUT, MT, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  w8a16_mma_kernel<LAYOUT, MT, VEC><<<blocks, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int LAYOUT, int VEC>
static int launch_mma_rows(const Args& a, int mt, int blocks, cudaStream_t st) {
  switch (mt) {
    case 1: return launch_mma<LAYOUT, 1, VEC>(a, blocks, st);
    case 2: return launch_mma<LAYOUT, 2, VEC>(a, blocks, st);
    case 4: return launch_mma<LAYOUT, 4, VEC>(a, blocks, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <int LAYOUT, int NC, int WBN>
static int launch_wgmma(const Args& a, int blocks, cudaStream_t stream) {
  using C = Wg<NC, WBN>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(w8a16_wgmma_kernel<LAYOUT, NC, WBN>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  Maps maps;
  memset(&maps, 0, sizeof maps);
  const int ex = x_map(&maps.x, a.x, a.K, a.M, C::BM);
  if (ex) return ex;
  for (int i = 0; i < a.nw; ++i) {
    const int e = LAYOUT == 0
                      ? weight_map(&maps.m[i], a.w[i].q, a.w[i].N, a.K, WBN, BK)
                      : weight_map(&maps.m[i], a.w[i].q, a.K, a.w[i].N, BK, WBN);
    if (e) return e;
  }
  w8a16_wgmma_kernel<LAYOUT, NC, WBN><<<blocks, C::THREADS, C::SMEM, stream>>>(maps, a);
  return (int)cudaGetLastError();
}

template <int LAYOUT>
static int launch_kernel(const Args& a, int kernel, int bm, int bn, int vec, int blocks,
                         cudaStream_t st) {
  if (kernel == 0) {
    if (bn != BN || bm % 16 || bm < 16 || bm > 64) return (int)cudaErrorInvalidValue;
    return vec == 16 ? launch_mma_rows<LAYOUT, 16>(a, bm / 16, blocks, st)
                     : launch_mma_rows<LAYOUT, 4>(a, bm / 16, blocks, st);
  }
  if (kernel == 1) {
    if (bm == 64 && bn == 64) return launch_wgmma<LAYOUT, 1, 64>(a, blocks, st);
    if (bm == 64 && bn == 128) return launch_wgmma<LAYOUT, 1, 128>(a, blocks, st);
    if (bm == 128 && bn == 128) return launch_wgmma<LAYOUT, 2, 128>(a, blocks, st);
    if (bm == 128 && bn == 256) return launch_wgmma<LAYOUT, 2, 256>(a, blocks, st);
    return (int)cudaErrorInvalidValue;
  }
  if (kernel == 2 && bm == FT && bn == FT) {
    w8a16_f32_kernel<LAYOUT><<<blocks, 256, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace kw8

// y_i [M, N_i] = (x [M, K] @ q_i) * s_i for the nw (1..3) weights i that
// share x, in one launch. kernel 0: mma.sync, bf16, bm = 16 * (1..4) rows
// per block, bn 128, vec 16 when every base and row stride is 16-byte
// aligned else 4; kernel 1: wgmma + TMA, bf16, (bm, bn) = (64, 64), (64,
// 128) or (128, 128), q_i and x on the 16-byte grid; kernel 2: float32 x
// and y, (bm, bn) = (64, 64), no split. layout 0: q_i [K, N_i] int8, s_i
// [N_i] f32; layout 1: q_i [N_i, K]. ks_i: K per split (a multiple of
// 64); a weight with ceil(K / ks_i) > 1 splits (M <= 64) and takes, in
// weight order, splits*M*N_i floats of part (rounded up to a multiple of
// 4) and ceil(M/bm)*ceil(N_i/bn) counters (zero, and left zero). Returns
// a cudaError_t (0 = launched).
extern "C" int w8a16_launch(const void* x, int M, int K, int layout, int kernel, int bm,
                            int bn, int vec, int nw, const void* q0, const void* s0, void* y0,
                            int N0, int ks0, const void* q1, const void* s1, void* y1, int N1,
                            int ks1, const void* q2, const void* s2, void* y2, int N2, int ks2,
                            void* part, void* counters, void* stream) {
  using namespace kw8;
  if (M < 1 || K < 1 || nw < 1 || nw > MAXW || bm < 1 || bn < 1 || (layout != 0 && layout != 1) ||
      (vec != 16 && vec != 4))
    return (int)cudaErrorInvalidValue;
  Args a;
  memset(&a, 0, sizeof a);
  a.x = x;
  a.M = M;
  a.K = K;
  a.nw = nw;
  a.rb = (M + bm - 1) / bm;
  const void* qs[MAXW] = {q0, q1, q2};
  const void* ss[MAXW] = {s0, s1, s2};
  void* ys[MAXW] = {y0, y1, y2};
  const int Ns[MAXW] = {N0, N1, N2}, kss[MAXW] = {ks0, ks1, ks2};
  float* p = static_cast<float*>(part);
  int* c = static_cast<int*>(counters);
  long long blocks = 0;
  for (int i = 0; i < nw; ++i) {
    Wt& w = a.w[i];
    if (Ns[i] < 1 || kss[i] < BK || kss[i] % BK) return (int)cudaErrorInvalidValue;
    w.q = static_cast<const int8_t*>(qs[i]);
    w.s = static_cast<const float*>(ss[i]);
    w.y = ys[i];
    w.N = Ns[i];
    w.k_split = kss[i];
    w.splits = (K + kss[i] - 1) / kss[i];
    w.cb = (w.N + bn - 1) / bn;
    w.blocks = a.rb * w.cb * w.splits;
    if (w.splits > 1) {
      if (M > 64 || kernel == 2 || !p || !c) return (int)cudaErrorInvalidValue;
      w.part = p;
      w.counters = c;
      p += ((size_t)w.splits * M * w.N + 3) & ~(size_t)3;  // the next weight's at 16 bytes
      c += a.rb * w.cb;
    }
    blocks += w.blocks;
  }
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return layout == 0 ? launch_kernel<0>(a, kernel, bm, bn, vec, (int)blocks, st)
                     : launch_kernel<1>(a, kernel, bm, bn, vec, (int)blocks, st);
}
