// Hopper pieces of the port's attention kernels: TMA tensor maps (encoded
// on the host, cached), mbarriers, warpgroup products (wgmma) and the
// tensor-core attention tile that flash_attention.cu and the prefill
// regime of paged_attention.cu share.
//
// The tile (tc_tile below). One block = one consumer warpgroup (128
// threads) + one producer warp. The consumer owns TQ = 64 query ROWS of
// one (batch, KV head): row r = s*G + g is query s of head kv*G + g, so a
// K/V tile is read once for the G heads that share it, and the 64 rows are
// the M of every wgmma. Q arrives once as one 3-D TMA box over q viewed as
// [B*S, H, D] (box [64/G, G, D]: 64/G whole positions; where G does not
// divide 64, G*floor(64/G) rows and the rest of the 64 is padding, so
// Qwen2.5's G = 7 takes 63 rows of 9 positions a tile). K and V arrive in tiles of TK = 64 keys,
// bf16, through a ring of STAGES shared-memory stages: the producer's one
// thread waits for a free stage (mbarrier "empty"), announces the bytes
// ("full", expect_tx) and issues the TMA boxes; the consumer waits on
// "full", runs S = Q K^T as wgmma m64n64k16 (A and B from shared memory),
// applies softcap and the mask to S in f32 registers, updates the online
// softmax there (a row's 16 values per thread sit in 4 lanes: max and sum
// by two shuffles; the scale folds into the exponential's FFMA), rescales
// O and runs O += P V as wgmma m64nDk16 with P converted to bf16 in
// registers (the accumulator layout of S is the A-fragment layout of the
// second product; P goes in as two bf16 terms, hi + lo, see below) and V
// read MN-major. Shared tiles are 128-byte (D >= 64) or 64-byte (D = 32)
// swizzled by TMA, and the wgmma descriptors name the same swizzle. Head
// dim 256 (Gemma): 4 chunks of 64 columns a tile (32 KB; Q plus two K/V
// stages 161 KB, 225 KB with a one-byte pool's staging ring), the
// 64 x 256 f32 output in 128 registers a thread, O += P V as two N = 128
// products.
// Conventions are the Pallas kernels': NEG_INF masking, p only for
// s > NEG_INF/2, l clamped at 1e-30, so a row with no visible key is 0.
//
// Measured on the H100 (chip_smoke.py and variants of this tile timed side
// by side): the softmax's scalar work, not the products or the loads,
// sets the tile's time, so it is kept lean; two consumer warpgroups
// sharing each K/V tile were slower than one per block.
//
// A one-byte K/V source (KT int8_t or __nv_fp8_e4m3: the paged prefill of
// a quantized pool) cannot feed wgmma, whose bf16 B operand must be bf16
// in shared memory (fp8 wgmma would need a quantized Q, other numerics
// than the reference's). Its tiles arrive by TMA, unswizzled, in a ring of
// one-byte stages, and a producer WARPGROUP (256 threads a block, not
// 160) widens each (exactly) into the bf16 stage in the 128- or 64-byte
// swizzled layout that TMA gives a bf16 tile, so the consumer's
// descriptors and products are the bf16 tile's and the widening of the
// next tile overlaps the products of this one. Measured on the H100 (1024
// queries at 1024, fp8 and int8 alike): widened by the consumer
// warpgroup itself, before its products, the tile took 0.19 ms, 2.2x the
// bf16 tile. The widening is generic-proxy writes read by wgmma through
// the async proxy: each producer thread fences (fence.proxy.async)
// before it arrives on the stage's "full" barrier (128 arrivals).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>
#include <mutex>

#include "attention_common.cuh"

namespace hop {

using kattn::NEG_INF;
using kattn::smem_u32;
using kattn::split_bf16;
typedef __nv_bfloat16 bf16;

constexpr int TQ = 64;          // query rows per block (wgmma M)
constexpr int TK = 64;          // keys per K/V tile
constexpr int STAGES = 2;       // K/V ring depth
constexpr int NTHREADS = 160;   // one consumer warpgroup + one producer warp
constexpr int NTHREADS_Q8 = 256;  // one-byte K/V: + a producer warpgroup

// Threads of a tile block over K/V of KT.
template <typename KT>
constexpr int tile_threads() {
  return sizeof(KT) == 1 ? NTHREADS_Q8 : NTHREADS;
}
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Geo {
  static constexpr int CW = D < 64 ? D : 64;  // columns of one swizzle chunk
  static constexpr int CWB = CW * 2;          // its bytes per row: 128 or 64
  static constexpr int NCH = D / CW;          // chunks across the head dim
  static constexpr int CHUNK = TK * CWB;      // bytes of one 64-row chunk
  static constexpr int TILE = TK * D * 2;     // bytes of one Q, K or V tile
  // wgmma descriptor layout type: 1 = 128-byte swizzle, 2 = 64-byte.
  static constexpr int LAYOUT = CWB == 128 ? 1 : 2;
  static constexpr CUtensorMapSwizzle SWIZZLE =
      CWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  // Q, STAGES x (K, V), barriers, and slack to align the base to 1 KB.
  static constexpr size_t SMEM = (size_t)(1 + 2 * STAGES) * TILE + 128 + 1024;
};

// ---------------------------------------------------------------------------
// Host: tensor maps. The encoder comes from the driver through the runtime,
// so the libraries link no libcuda. Maps are cached by (pointer, shape,
// box): the KV pool and the step's q buffers repeat from layer to layer.

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

static EncodeTiledFn encoder() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return (EncodeTiledFn) nullptr;
    return (EncodeTiledFn)p;
  }();
  return fn;
}

struct MapKey {
  const void* ptr;
  uint64_t rows, heads, d;
  uint32_t box_rows, box_heads, box_d;
  int swizzle, type;
  bool operator==(const MapKey& o) const { return memcmp(this, &o, sizeof(MapKey)) == 0; }
};

// A bf16 (or, with type UINT8, one-byte) tensor viewed as [rows, heads, d]
// (contiguous), boxes of [box_rows, box_heads, box_d]. Returns a
// cudaError_t.
static int tensor_map(CUtensorMap* out, const void* ptr, uint64_t rows, uint64_t heads,
                      uint64_t d, uint32_t box_rows, uint32_t box_heads, uint32_t box_d,
                      CUtensorMapSwizzle swizzle,
                      CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  constexpr int N = 64;
  static std::mutex mu;
  static MapKey keys[N];
  static CUtensorMap maps[N];
  static int used = 0, next = 0;
  MapKey key;
  memset(&key, 0, sizeof key);
  key.ptr = ptr; key.rows = rows; key.heads = heads; key.d = d;
  key.box_rows = box_rows; key.box_heads = box_heads; key.box_d = box_d;
  key.swizzle = (int)swizzle;
  key.type = (int)type;
  const uint64_t esize = type == CU_TENSOR_MAP_DATA_TYPE_UINT8 ? 1 : 2;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i)
    if (keys[i] == key) {
      *out = maps[i];
      return 0;
    }
  EncodeTiledFn enc = encoder();
  if (!enc) return (int)cudaErrorNotSupported;
  cuuint64_t dims[3] = {d, heads, rows};
  cuuint64_t strides[2] = {d * esize, heads * d * esize};
  cuuint32_t box[3] = {box_d, box_heads, box_rows};
  cuuint32_t estr[3] = {1, 1, 1};
  CUresult r = enc(out, type, 3, const_cast<void*>(ptr), dims,
                   strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  const int slot = used < N ? used++ : next;
  next = (slot + 1) % N;
  keys[slot] = key;
  maps[slot] = *out;
  return 0;
}

// ---------------------------------------------------------------------------
// Device: barriers, TMA, wgmma.

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One 3-D box of a tensor map into shared memory, completing on *bar*.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c_d, int c_head, int c_row) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c_d), "r"(c_head), "r"(c_row)
      : "memory");
}

// 2^x by the hardware's approximation (relative error ~2^-22; -inf-like
// arguments give 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pins accumulator registers around the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle layout type.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              int layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

// The wgmma forms the tile uses, with every accumulator register named.
// S = Q K^T: A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// O += P V: A (P, bf16) from registers, B (V) MN-major (imm-trans-b = 1);
// the accumulator is always added to (scale-d true).
__device__ __forceinline__ void wgmma_rs_m64n32_tb(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n64_tb(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n128_tb(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
struct PV;
template <>
struct PV<32> {
  __device__ __forceinline__ static void mma(float (&o)[16], const uint32_t (&a)[4], uint64_t b) {
    wgmma_rs_m64n32_tb(o, a, b);
  }
};
template <>
struct PV<64> {
  __device__ __forceinline__ static void mma(float (&o)[32], const uint32_t (&a)[4], uint64_t b) {
    wgmma_rs_m64n64_tb(o, a, b);
  }
};
template <>
struct PV<128> {
  __device__ __forceinline__ static void mma(float (&o)[64], const uint32_t (&a)[4], uint64_t b) {
    wgmma_rs_m64n128_tb(o, a, b);
  }
};
// Head dim 256: two N = 128 products, columns 0-127 and 128-255 (the
// accumulator layout of N = 256 is the two N = 128 layouts in turn; the
// second half of V starts two 64-column chunks, 2 * CHUNK bytes, on).
template <>
struct PV<256> {
  __device__ __forceinline__ static void mma(float (&o)[128], const uint32_t (&a)[4], uint64_t b) {
    wgmma_rs_m64n128_tb(*reinterpret_cast<float(*)[64]>(o), a, b);
    wgmma_rs_m64n128_tb(*reinterpret_cast<float(*)[64]>(o + 64), a,
                        b + ((2 * Geo<256>::CHUNK) >> 4));
  }
};

// ---------------------------------------------------------------------------
// The tile. Src supplies the K/V boxes of the key tile at k0, 2 * TILE
// bytes in all (whole tiles: rows past the last key are real, finite rows
// that the mask drops):
//   void load(int k0, uint32_t k_dst, uint32_t v_dst, uint32_t bar) const;
// Query s (0-based in its sequence) sits at absolute position qoff + s and
// sees keys kpos <= qoff + s with kpos < klimit.

struct TileArgs {
  bf16* out;      // [B, S, H, D]
  int S, H, G, b, kv, tile;
  int qoff, klimit;
  float scale, softcap;
  float out_scale = 1.f;  // the output's factor: a quantized pool's v_scale
};

// Shared memory of a tile over K/V of KT: the bf16 layout, and for a
// one-byte KT its ring of STAGES one-byte (K, V) stages.
template <int D, typename KT>
constexpr size_t tile_smem() {
  return Geo<D>::SMEM + (sizeof(KT) == 1 ? (size_t)STAGES * 2 * TK * D : 0);
}

// Widens a one-byte K or V tile [TK][D] (unswizzled) into the bf16 tile
// at dst in TMA's swizzled layout (chunks of CW columns CHUNK bytes
// apart; 16-byte units of a row XOR the row's address bits 7-9 for
// 128-byte rows, 7-8 for 64-byte rows). Thread t of the 128 takes 16
// bytes at a time.
template <int D, typename KT>
__device__ __forceinline__ void widen_tile(const unsigned char* in, unsigned char* dst, int t) {
  using Gm = Geo<D>;
  constexpr int SW = Gm::CWB / 16 - 1;
#pragma unroll 4
  for (int u = t; u < TK * D / 16; u += 128) {
    const int j = u / (D / 16), col = (u - j * (D / 16)) * 16;
    const uint4 b = *reinterpret_cast<const uint4*>(in + j * D + col);
    const uint4 w[2] = {kattn::widen8_bf16<KT>(make_uint2(b.x, b.y)),
                        kattn::widen8_bf16<KT>(make_uint2(b.z, b.w))};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = col + 8 * h;  // first of 8 columns
      const int a = j * Gm::CWB + (c % Gm::CW) * 2;
      *reinterpret_cast<uint4*>(dst + (c / Gm::CW) * Gm::CHUNK + (a ^ (((a >> 7) & SW) << 4))) =
          w[h];
    }
  }
}

template <int D, typename KT = bf16, typename Src>
__device__ __forceinline__ void tc_tile(const CUtensorMap* qmap, const Src& src,
                                        const TileArgs& a, unsigned char* smem_raw) {
  using Gm = Geo<D>;
  constexpr bool Q8 = sizeof(KT) == 1;  // one-byte K/V: staged, then widened
  constexpr int IN_TILE = TK * D;       // bytes of a staged K or V tile
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - smem_u32(smem_raw));  // Q8: generic view
  const uint32_t q_s = base;
  const uint32_t k_s = base + Gm::TILE;                    // + stage * TILE
  const uint32_t v_s = base + (1 + STAGES) * Gm::TILE;     // + stage * TILE
  const uint32_t in_s = base + (1 + 2 * STAGES) * Gm::TILE;  // Q8: + stage * 2 * IN_TILE
  const uint32_t bars = in_s + (Q8 ? STAGES * 2 * IN_TILE : 0);
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };
  const uint32_t q_bar = bars + 8u * (2 * STAGES);
  auto landed = [&](int s) { return bars + 8u * (2 * STAGES + 1 + s); };  // Q8: TMA done

  // A tile holds PQ = 64 / G whole positions, RQ = PQ * G <= 64 rows (G
  // not dividing 64: 63 rows at G = 7, the last wgmma row padding; its Q
  // row is left as it was, its scores, softmax and output stay in that
  // row and are never stored).
  const int G = a.G, S = a.S;
  const int PQ = TQ / G, RQ = PQ * G;
  const int r0 = a.tile * RQ;  // first packed row
  const int s_first = a.tile * PQ;
  const int s_last = min(S - 1, s_first + PQ - 1);
  const int n_keys = max(0, min(a.klimit, a.qoff + s_last + 1));
  const int n_kt = (n_keys + TK - 1) / TK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), Q8 ? 128 : 1);
      mbar_init(empty(s), 128);
      if (Q8) mbar_init(landed(s), 1);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if constexpr (Q8) {
    if (threadIdx.x >= 128) {
      // Producer warpgroup: its first thread issues Q and the one-byte
      // boxes of each key tile into one-byte stage t % STAGES; all 128
      // wait for tile t to land and for the consumer to free bf16 stage
      // t % STAGES (tile t - STAGES done), widen, fence, arrive on
      // "full", meet, and the first thread refills the one-byte stage
      // with tile t + STAGES.
      const int pt = threadIdx.x - 128;
      auto issue = [&](int t) {
        const int st = t % STAGES;
        const uint32_t in = in_s + st * 2 * IN_TILE;
        mbar_expect_tx(landed(st), 2 * IN_TILE);
        src.load(t * TK, in, in + IN_TILE, landed(st));
      };
      if (pt == 0) {
        mbar_expect_tx(q_bar, RQ * D * 2);
#pragma unroll
        for (int c = 0; c < Gm::NCH; ++c)
          tma_load(q_s + c * Gm::CHUNK, qmap, q_bar, c * Gm::CW, a.kv * G, a.b * S + s_first);
        for (int t = 0; t < STAGES && t < n_kt; ++t) issue(t);
      }
      for (int t = 0; t < n_kt; ++t) {
        const int st = t % STAGES;
        mbar_wait(landed(st), (t / STAGES) & 1);
        mbar_wait(empty(st), ((t / STAGES) & 1) ^ 1);
        const unsigned char* in = gbase + (in_s - base) + st * 2 * IN_TILE;
        widen_tile<D, KT>(in, gbase + (k_s - base) + st * Gm::TILE, pt);
        widen_tile<D, KT>(in + IN_TILE, gbase + (v_s - base) + st * Gm::TILE, pt);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(full(st));
        asm volatile("bar.sync 1, 128;\n" ::: "memory");  // one-byte stage st read by all
        if (pt == 0 && t + STAGES < n_kt) issue(t + STAGES);
      }
      return;
    }
  } else {
    if (threadIdx.x >= 128) {
      // Producer: one thread issues every copy.
      if (threadIdx.x == 128) {
        mbar_expect_tx(q_bar, RQ * D * 2);
#pragma unroll
        for (int c = 0; c < Gm::NCH; ++c)
          tma_load(q_s + c * Gm::CHUNK, qmap, q_bar, c * Gm::CW, a.kv * G, a.b * S + s_first);
        for (int t = 0; t < n_kt; ++t) {
          const int st = t % STAGES;
          mbar_wait(empty(st), ((t / STAGES) & 1) ^ 1);
          mbar_expect_tx(full(st), 2 * Gm::TILE);
          src.load(t * TK, k_s + st * Gm::TILE, v_s + st * Gm::TILE, full(st));
        }
      }
      return;
    }
  }

  // Consumer warpgroup. Thread (warp w, lane l) holds rows w*16 + l/4
  // ("lo") and that + 8 ("hi"); in S, columns j*8 + (l%4)*2 + {0,1}.
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row_lo = warp * 16 + (lane >> 2);
  const int s_lo = (r0 + row_lo) / G, s_hi = (r0 + row_lo + 8) / G;
  const int qp_lo = a.qoff + s_lo, qp_hi = a.qoff + s_hi;
  const float scale2 = a.scale * LOG2E;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.f, l_hi = 0.f;

  mbar_wait(q_bar, 0);
  for (int t = 0; t < n_kt; ++t) {
    const int st = t % STAGES;
    const int k0 = t * TK;
    mbar_wait(full(st), (t / STAGES) & 1);
    const uint32_t ks = k_s + st * Gm::TILE, vs = v_s + st * Gm::TILE;

    // S = Q K^T: D/16 steps of k16; both operands K-major, a step moves
    // 32 bytes along a swizzled row, a chunk moves CHUNK bytes.
    float s[32];
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k) {
      const uint32_t off = (k / (Gm::CW / 16)) * Gm::CHUNK + (k % (Gm::CW / 16)) * 32;
      wgmma_ss_m64n64(s, make_desc(q_s + off, 16, 8 * Gm::CWB, Gm::LAYOUT),
                      make_desc(ks + off, 16, 8 * Gm::CWB, Gm::LAYOUT), k > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // Softcap (when set) turns S into capped scores; the scale is then 1.
    // The mask, only where a tile crosses the diagonal or the key limit,
    // sets NEG_INF. Row max on these scores (the scale is positive, so
    // the max is the same), then p = 2^(x*c - m*c) with c = scale*log2(e)
    // as one FFMA into the exponential.
    float c2 = scale2;
    if (a.softcap > 0.f) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = a.softcap * tanhf(s[i] * a.scale / a.softcap);
      c2 = LOG2E;
    }
    const bool edge = k0 + TK > a.klimit || k0 + TK - 1 > a.qoff + s_first;
    if (edge) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + j * 8 + (lane & 3) * 2 + (e & 1);
          if (!(key < a.klimit && key <= (e < 2 ? qp_lo : qp_hi))) s[j * 4 + e] = NEG_INF;
        }
    }
    float mx_lo = NEG_INF, mx_hi = NEG_INF;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[j * 4 + 0], s[j * 4 + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[j * 4 + 2], s[j * 4 + 3]));
    }
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float neg_lo = -mn_lo * c2, neg_hi = -mn_hi * c2;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j * 4 + e];
        float p = ex2(fmaf(x, c2, e < 2 ? neg_lo : neg_hi));
        // Masked scores only exist on edge tiles: there p enters for
        // x > NEG_INF/2 alone (a row with no key so far has m = NEG_INF).
        if (edge && !(x > NEG_INF / 2)) p = 0.f;
        s[j * 4 + e] = p;
        if (e < 2) sum_lo += p; else sum_hi += p;
      }
    }
    sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, 1);
    sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, 2);
    sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, 1);
    sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, 2);
    const float al_lo = ex2((m_lo - mn_lo) * c2), al_hi = ex2((m_hi - mn_hi) * c2);
    l_lo = l_lo * al_lo + sum_lo;
    l_hi = l_hi * al_hi + sum_hi;
    m_lo = mn_lo;
    m_hi = mn_hi;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j * 4 + 0] *= al_lo;
      o[j * 4 + 1] *= al_lo;
      o[j * 4 + 2] *= al_hi;
      o[j * 4 + 3] *= al_hi;
    }
    // P as the A operand, in two bf16 terms (hi + lo): P V then keeps ~16
    // mantissa bits of P, not bf16's 8, so the product adds no error
    // beyond the output's own rounding. Key step kk (16 keys) takes S's
    // column blocks 2kk and 2kk+1.
    uint32_t pa[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1], pa[kk][i], pl[kk][i]);
    // O += P V: V is MN-major (head dim contiguous); a key step moves 16
    // rows, chunks of CW columns sit CHUNK bytes apart (LBO), 8-row groups
    // 8*CWB bytes apart (SBO).
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t vd = make_desc(vs + kk * 16 * Gm::CWB, Gm::CHUNK, 8 * Gm::CWB, Gm::LAYOUT);
      PV<D>::mma(o, pa[kk], vd);
      PV<D>::mma(o, pl[kk], vd);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    mbar_arrive(empty(st));
  }

  const float inv_lo = a.out_scale / fmaxf(l_lo, 1e-30f);
  const float inv_hi = a.out_scale / fmaxf(l_hi, 1e-30f);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rg = r0 + row_lo + 8 * h, sq = rg / G, g = rg - sq * G;
    if (row_lo + 8 * h >= RQ || sq >= S) continue;
    const float inv = h ? inv_hi : inv_lo;
    bf16* dst = a.out + ((size_t)(a.b * S + sq) * a.H + a.kv * G + g) * D + (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
          __floats2bfloat162_rn(o[j * 4 + 2 * h] * inv, o[j * 4 + 2 * h + 1] * inv);
  }
}

}  // namespace hop
