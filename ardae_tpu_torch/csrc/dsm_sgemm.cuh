// Shared core of the hand-written DSM kernels (fused_dsm.cu and
// fused_dsm_grad.cu) for NVIDIA Hopper (sm_90a):
//  * one GEMM on the tensor cores in one of two precisions, a template
//    parameter (Prec), built from Hopper's own means: TMA copies, mbarrier
//    rings, warpgroup wgmma.mma_async, and a persistent, warp-specialised
//    block. PREC_F32, fp32-accurate, 3xTF32: each fp32 operand x is split
//    as hi = tf32(x), lo = tf32(x - hi) (rounded as cvt.rna.tf32.f32
//    rounds), and three TF32 products lo*hi + hi*lo + hi*hi, small terms
//    first, sum into fp32 (about 21 of fp32's 24 bits kept). PREC_BF16 (the
//    TPU grad kernels' bf16 compute mode): each fp32 operand is rounded once
//    to bf16 (nearest even, the values the earlier warp-level core gave at
//    each fragment read) and one bf16 product sums into fp32. The epilogue
//    is a functor, so each chain fuses its own bias / activation / product,
//    fed row by row from shared memory;
//  * deterministic reductions without atomics: split-K partials summed in a
//    fixed order, column sums over fixed row segments, fixed-grid block sums;
//  * the activations phi and the factors phi' and phi''/phi' taken from the
//    post-activation u = phi(pre).
//
// What bounds it, and what the design does about it. The products: wgmma
// is the only way to the card's tensor-core rate (measured on an H100 80GB
// HBM3 at 700 W, scripts/torch_mma_peak.py: m64n128k8 TF32 488-489 TFLOP/s,
// m64n128k16 bf16 977-979, against the warp-level m16n8k8 product's 303-318
// TF32), so the 3xTF32 ceiling is ~163 TFLOP/s of fp32 products. The core
// reaches (same card, scripts/torch_dsm_measure.py core, TFLOP/s of fp32
// products): 86 and 61 in the h x h products at h 512 and 256, 78 and 69
// in their weight gradients; bf16 139, 90, 134 and 111. What holds it
// below the ceiling: each consumer warpgroup waits for its own group before
// it adds the group to its running sum and converts the next A, and the
// epilogue runs between units, not under them (at h 256 a unit has only 8
// k-tiles). The block (384 threads, one an SM, up to 225 KB of dynamic
// shared memory):
//  * warp 0, the loader: one lane issues cp.async.bulk.tensor (TMA) copies
//    of each k-tile (128 x 32, 128-byte swizzle) into a ring of stages, each
//    guarded by a full and an empty mbarrier. The tensor maps are made on
//    the host (cuTensorMapEncodeTiled, reached through
//    cudaGetDriverEntryPointByVersion, so no libcuda is linked). An A or an
//    activation B that TMA cannot take (a base or row stride not 16-byte
//    aligned: rows of d = 2 or 5 floats) is copied by the loader's 32 lanes
//    with 4-byte cp.async into the same swizzled layout, zero-filled at the
//    edge, each lane arriving on the full barrier with
//    cp.async.mbarrier.arrive; the host counts such operands
//    (dsm_sgemm_cp_async_operands);
//  * B, converted once a call or once a tile, never once a warp: a product
//    with a weight (every forward, tangent, input-gradient and adjoint
//    product) takes B = W or W^T converted by prep_b into tf32 hi and lo (or
//    bf16) rows, K-major, which TMA copies straight into wgmma's swizzled
//    layout; l0's weight (stride in + 1) and the transposes need no packed
//    copy of their own. (Taking an fp32 weight as a raw 16 KB tile and
//    splitting it in the stagers moves a third fewer bytes, but measured
//    slower on the card.) A weight gradient's B (the activations, N-major) is
//    converted by the stagers, warps 1-3: split or rounded, transposed, and
//    written K-major into a ring of staged tiles, fenced for the async
//    proxy (fence.proxy.async) before they arrive on its barrier;
//  * warps 4-11, two consumer warpgroups (setmaxnreg 232 registers, the
//    producer warpgroup 40), 64 rows each: A goes into wgmma's register
//    fragments, split or rounded there once, and each k-tile issues three
//    m64n128k8 TF32 products a k-step (or one m64n128k16 bf16) with B from
//    shared memory. ptxas treats an issued wgmma's A registers as free (the
//    SASS showed the next k-tile's loads landing in them while the group
//    still read them), so nothing is written between issuing a group and
//    waiting for it: the next k-tile's A loads are issued before the group
//    and converted after the wait. The tensor cores round their fp32
//    accumulation toward zero, which over a long k range (a weight
//    gradient's ~5,000 rows a split) biases the sum, so each k-tile's
//    products go into a fresh accumulator, added to the running sum with a
//    round-to-nearest fp32 add: kept in every instantiation (64 + 64
//    accumulator registers a thread);
//  * persistent: the grid holds one block an SM, and block b walks the
//    units (output tile, split) b, b + grid, ... in a fixed order, so that
//    the loader fetches the next unit while the consumers finish one. Each
//    unit sums its k-tiles in one fixed order and nothing is atomic, so
//    results are bitwise repeatable; split-K partials go to scratch and
//    reduce_splits sums them in split order;
//  * the epilogue: each consumer warpgroup writes its accumulators to its
//    half of a 64 KB tile (XOR-swizzled, free of bank conflicts) and hands
//    the functor 32 consecutive columns of a row a warp, 16 rows' inputs
//    loaded before their stores. (Handing the tile to warps 1-3, so that it
//    ran under the next unit's products, doubled the forward's time on the
//    card: three warps at 56 registers spilled and could not keep the
//    functors' loads in flight. Staging half the tile at a time, to make
//    room for a fourth ring stage, measured slower too.)
// Each including file gets its own copy (anonymous namespace).

#pragma once

#include <cuda.h>           // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 32;   // block tile; k-tile of 32 floats
constexpr int NT = 384;         // producer warpgroup + two consumer warpgroups
constexpr int STAGERS = 96;     // warps 1-3
constexpr int TILE_FLOATS = BM * BK;          // one raw operand k-tile
constexpr int TILE_BYTES = TILE_FLOATS * 4;   // 16 KB
constexpr int EPI_BATCH = 16;       // epilogue rows a thread loads at once
constexpr int LOSS_BLOCKS = 264;    // two blocks per SM of an H100 SXM
constexpr int WGRAD_BLOCKS = 264;   // weight-gradient units: two an SM
constexpr int COLSUM_SEGS = 64;     // row segments of a split column sum
constexpr int COLSUM_COLS = 32;     // a column-sum block: 32 columns (a warp
constexpr int COLSUM_LANES = 8;     // reads 128 B of a row) x 8 row lanes

static_assert(BM == BN && BM == 128 && BK == 32, "the layouts below assume it");

enum Act { ACT_SOFTPLUS = 0, ACT_RELU = 1, ACT_TANH = 2 };
// the products' precision: fp32-accurate (3xTF32) or operands in bf16
enum Prec { PREC_F32 = 0, PREC_BF16 = 1 };

// bytes of one staged B tile: tf32 hi and lo, or bf16
__host__ __device__ constexpr int staged_bytes(int prec) {
  return prec == PREC_F32 ? 2 * TILE_BYTES : TILE_BYTES / 2;
}


__device__ __forceinline__ float act_fwd(int act, float v) {
  if (act == ACT_SOFTPLUS) return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
  if (act == ACT_RELU) return fmaxf(v, 0.f);
  return tanhf(v);
}

// phi'(pre) from the post-activation u = phi(pre)
__device__ __forceinline__ float act_grad_from_out(int act, float u) {
  if (act == ACT_SOFTPLUS) return -expm1f(-u);   // sigmoid(pre)
  if (act == ACT_RELU) return u > 0.f ? 1.f : 0.f;
  return 1.f - u * u;
}

// phi''(pre) / phi'(pre) from u = phi(pre), so that phi'' = phi' * this:
// softplus 1 - sigmoid(pre) = exp(-u); relu 0; tanh -2 tanh(pre)
__device__ __forceinline__ float act_curv_from_out(int act, float u) {
  if (act == ACT_SOFTPLUS) return expf(-u);
  if (act == ACT_RELU) return 0.f;
  return -2.f * u;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- the layouts ----
// A raw k-tile as TMA writes it with the 128-byte swizzle (the 16-byte chunk
// index, address bits 4-6, XORed with bits 7-9), in floats, for element
// (r, k) of an operand of 128 rows r: K-contiguous ([r][32 k], one box of
// 32 x 128) or M/N-contiguous (four boxes of [32 k][32 r], 4 KB each).
template <bool KC>
__device__ __forceinline__ int raw_off(int r, int k) {
  if (KC) return r * BK + ((((k >> 2) ^ (r & 7)) << 2) | (k & 3));
  return (r >> 5) * (32 * BK) + k * 32 +
         (((((r & 31) >> 2) ^ (k & 7)) << 2) | (r & 3));
}

// a staged bf16 pair (k, k + 1), k even, of row n: its 32-bit word in the
// K-major 64-byte-swizzled tile ([n][32 k] bf16, 64 bytes a row)
__device__ __forceinline__ int bf16_word(int n, int k) {
  return n * 16 + ((((k >> 3) ^ ((n >> 1) & 3)) << 2) | ((k & 7) >> 1));
}

// x = hi + lo to ~22 bits. hi = tf32(x) and lo = tf32(x - hi) (x - hi is
// exact), each rounded to nearest with ties away from zero on the 13
// mantissa bits TF32 drops: the rounding of cvt.rna.tf32.f32, written as an
// integer add and mask because ptxas expands cvt.rna into four
// instructions. lo keeps its low 13 bits, which the tensor cores do not read.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// Two fp32 values rounded to the nearest bf16 (ties to even) and packed in
// one register, lo in the low half: the lower k of a pair
// (cvt.rn.bf16x2.f32 puts its first source in the upper half).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// ---- mbarriers, TMA, cp.async ----
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// one 2-D TMA box into shared memory, completing on bar's transaction count
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// copy 4 bytes from global src to shared dst, or write 0 where !in
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

// arrive on bar once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id) {   // one warpgroup
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// ---- wgmma ----
// Shared-memory matrix descriptor of a K-major swizzled tile: start address,
// leading byte offset (unused by swizzled K-major layouts: 1), stride byte
// offset between 8-row groups (sbo), swizzle (1: 128 B, 2: 64 B).
__device__ __forceinline__ uint64_t gmma_desc(const void* p, int sbo, int swz) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)swz << 62);
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

// keeps the compiler from moving accesses of d across a wgmma wait
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define DSM_D8(i)                                                           \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define DSM_D64                                                       \
  DSM_D8(0), DSM_D8(8), DSM_D8(16), DSM_D8(24), DSM_D8(32), DSM_D8(40), \
      DSM_D8(48), DSM_D8(56)
#define DSM_DREGS                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x 128, fp32) = a (64 x 8, tf32, registers) * b (8 x 128, tf32,
// K-major in shared memory) + (acc ? d : 0). Thread (warp w of the
// warpgroup, g = lane / 4, t = lane % 4) holds a = {(16w + g, t),
// (16w + g + 8, t), (16w + g, t + 4), (16w + g + 8, t + 4)} and d[4j + q] =
// (16w + g + 8 (q / 2), 8j + 2t + q % 2).
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " DSM_DREGS
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : DSM_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// the same in bf16, k 16: a = {(16w + g, 2t..2t+1), (16w + g + 8, 2t..2t+1),
// (16w + g, 2t+8..2t+9), (16w + g + 8, 2t+8..2t+9)}, pairs with the lower k
// in the low half; b K-major (no transpose)
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " DSM_DREGS
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : DSM_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// ---- the GEMM ----
struct GemmShape {
  int M, N, K;
  int kps;               // k range of a split, a multiple of BK
  int tiles_m, tiles_n, units;
};

struct Operand {
  const float* p;
  int ld;
  int tma;               // 1: TMA, 0: the loader's cp.async copies
};

// unit u -> (split z, first row m0, first column n0, k range)
struct Unit {
  int z, m0, n0, k_lo, nk;
};

__device__ __forceinline__ Unit unit_at(const GemmShape& s, int u) {
  const int tiles = s.tiles_m * s.tiles_n;
  Unit w;
  w.z = u / tiles;
  const int rem = u - w.z * tiles;
  w.m0 = rem / s.tiles_n * BM;
  w.n0 = rem % s.tiles_n * BN;
  w.k_lo = w.z * s.kps;
  const int k_hi = min(s.K, w.k_lo + s.kps);
  w.nk = k_hi > w.k_lo ? (k_hi - w.k_lo + BK - 1) / BK : 0;
  return w;
}

// The ring of one instantiation. B_KC (every product with a weight): a
// stage holds the raw A k-tile and B already converted, as wgmma reads it
// (the entry point converted the weight once, prep_b); no staging. !B_KC
// (the weight gradients): a stage holds both raw k-tiles, and the stagers
// convert B into a ring of SSTAGES staged tiles.
template <bool B_KC, int PREC>
struct Ring {
  static constexpr int STAGES = B_KC ? (PREC == PREC_F32 ? 3 : 6) : 3;
  static constexpr int SSTAGES = B_KC ? 0 : 2;
  static constexpr int B_BYTES = B_KC ? staged_bytes(PREC) : TILE_BYTES;
  static constexpr int STAGE_BYTES = TILE_BYTES + B_BYTES;
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES +
                              SSTAGES * staged_bytes(PREC) + BM * BN * 4 +
                              16 * (STAGES + SSTAGES);
  static_assert(SMEM <= 232448, "fits an H100 SM");
};

// dynamic shared memory of a GEMM block: the ring, the staged ring, the
// epilogue tile, the mbarriers, and room to align the base to 1024 bytes
// (the 128-byte swizzle's period)
__host__ __device__ constexpr int sgemm_smem_bytes(bool b_kc, int prec) {
  return b_kc ? (prec == PREC_F32 ? Ring<true, PREC_F32>::SMEM
                                  : Ring<true, PREC_BF16>::SMEM)
              : (prec == PREC_F32 ? Ring<false, PREC_F32>::SMEM
                                  : Ring<false, PREC_BF16>::SMEM);
}

// The loader's copy of one operand's k-tile when TMA cannot take it: lanes
// along the contiguous axis, zero past (rows, K).
template <bool KC>
__device__ __forceinline__ void copy_tile(float* dst, const Operand& o, int rows,
                                          int K, int r0, int k0, int lane) {
  if (KC) {
    const int k = k0 + lane;
#pragma unroll 8
    for (int r = 0; r < BM; ++r) {
      const bool in = r0 + r < rows && k < K;
      cp_async4(dst + raw_off<true>(r, lane),
                in ? o.p + (long long)(r0 + r) * o.ld + k : o.p, in);
    }
  } else {
#pragma unroll 4
    for (int k = 0; k < BK; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 32 * j + lane;
        const bool in = r0 + r < rows && k0 + k < K;
        cp_async4(dst + raw_off<false>(r, k),
                  in ? o.p + (long long)(k0 + k) * o.ld + r0 + r : o.p, in);
      }
  }
}

// one operand's k-tile by TMA: one 32 x 128 box (K-contiguous, coordinates
// (k, row)) or four 32 x 32 boxes (M/N-contiguous, (row, k))
template <bool KC>
__device__ __forceinline__ void tma_tile(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int r0, int k0) {
  if (KC) {
    tma_load(dst, map, bar, k0, r0);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      tma_load(static_cast<float*>(dst) + j * 32 * BK, map, bar, r0 + 32 * j, k0);
  }
}

// The stagers' conversion of one raw N-contiguous B k-tile (thread st of
// STAGERS) into the staged tile wgmma reads, a transpose on the way: 16
// bytes (4 n at one k) read a step, lanes along k. PREC_F32: tf32 hi and lo
// in two 16 KB tiles, K-major with the 128-byte swizzle (the layout of a raw
// K-contiguous tile); PREC_BF16: one 8 KB tile of bf16 pairs (k, k + 1),
// K-major with the 64-byte swizzle.
template <int PREC>
__device__ __forceinline__ void stage_b(const float* __restrict__ raw, void* stg,
                                        int st) {
  if constexpr (PREC == PREC_F32) {
    uint32_t* hi = static_cast<uint32_t*>(stg);
    uint32_t* lo = hi + TILE_FLOATS;
#pragma unroll 2
    for (int i = st; i < TILE_FLOATS / 4; i += STAGERS) {
      const int k = i & 31, n = (i >> 5) * 4;
      const float4 v = *reinterpret_cast<const float4*>(raw + raw_off<false>(n, k));
      const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t h, l;
        split_tf32(x[e], h, l);
        const int o = raw_off<true>(n + e, k);
        hi[o] = h;
        lo[o] = l;
      }
    }
  } else {
    uint32_t* w = static_cast<uint32_t*>(stg);
#pragma unroll 2
    for (int i = st; i < TILE_FLOATS / 8; i += STAGERS) {
      const int k = 2 * (i & 15), n = (i >> 4) * 4;
      const float4 v0 = *reinterpret_cast<const float4*>(raw + raw_off<false>(n, k));
      const float4 v1 = *reinterpret_cast<const float4*>(raw + raw_off<false>(n, k + 1));
      w[bf16_word(n, k)] = pack_bf16x2(v0.x, v1.x);
      w[bf16_word(n + 1, k)] = pack_bf16x2(v0.y, v1.y);
      w[bf16_word(n + 2, k)] = pack_bf16x2(v0.z, v1.z);
      w[bf16_word(n + 3, k)] = pack_bf16x2(v0.w, v1.w);
    }
  }
}

// A consumer thread's raw A values of one k-tile, read ahead: rows ra and
// ra + 8 (ra = 16 w + g of the warpgroup's 64 rows, w its warp) in wgmma's
// fragment order; PREC_F32 (k) = (t, t + 4) of each k-step of 8, PREC_BF16
// the pairs (2t, 2t + 1) and (2t + 8, 2t + 9) of each k-step of 16
struct ARegs {
  float x[4][4];
};

template <bool A_KC, int PREC>
__device__ __forceinline__ void load_a(ARegs& f, const float* as, int ra, int t) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = ra + 8 * (q & 1);
      // bf16: s = 2 k-step + (the pair's second value)
      const int k = PREC == PREC_F32 ? 8 * s + t + 4 * (q >> 1)
                                     : 16 * (s >> 1) + 2 * t + 8 * (q >> 1) + (s & 1);
      f.x[s][q] = as[raw_off<A_KC>(r, k)];
    }
}

// A k-tile's wgmma A fragments, converted once from its raw values: PREC_F32
// each value split into tf32 hi and lo, PREC_BF16 each pair rounded to bf16
// and packed (the lower k in the low half). wgmma reads these registers
// until its group completes, and ptxas hands registers that an issued
// wgmma still reads to later instructions (seen in the SASS, where the next
// k-tile's loads overwrote them): so the consumer issues the next k-tile's
// loads before the group, waits for the group right after issuing it, and
// converts only after the wait.
template <int PREC>
struct Frag;
template <>
struct Frag<PREC_F32> {
  uint32_t h[4][4], l[4][4];
  __device__ __forceinline__ void set(const ARegs& a) {
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int q = 0; q < 4; ++q) split_tf32(a.x[s][q], h[s][q], l[s][q]);
  }
};
template <>
struct Frag<PREC_BF16> {
  uint32_t b[2][4];
  __device__ __forceinline__ void set(const ARegs& a) {
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        b[s][q] = pack_bf16x2(a.x[2 * s][q], a.x[2 * s + 1][q]);
  }
};

// part = the k-tile's products, a fresh accumulator: 3xTF32 (small terms
// first: lo*hi, hi*lo, then hi*hi, each k-step) or bf16, B from the staged
// tile bs (tf32 hi, then lo 16 KB on; or bf16). Issued and committed; the
// caller waits.
template <int PREC>
__device__ __forceinline__ void mma_tile(float (&part)[64], const Frag<PREC>& f,
                                         const uint8_t* bs) {
  fence_acc(part);
  wgmma_fence();
  if constexpr (PREC == PREC_F32) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint64_t bh = gmma_desc(bs + 32 * s, 1024, 1);
      const uint64_t bl = gmma_desc(bs + TILE_BYTES + 32 * s, 1024, 1);
      wgmma_tf32(part, f.l[s], bh, s > 0);
      wgmma_tf32(part, f.h[s], bl, 1);
      wgmma_tf32(part, f.h[s], bh, 1);
    }
  } else {
#pragma unroll
    for (int s = 0; s < 2; ++s)
      wgmma_bf16(part, f.b[s], gmma_desc(bs + 32 * s, 512, 2), s > 0);
  }
  wgmma_commit();
}

// The epilogue of rows r0 .. r0 + rows - 1 of a unit's tile, staged in cs
// (column c of row r at c ^ 4 (r % 8): the accumulators' writes and these
// reads are free of bank conflicts): thread i of n takes elements i, i + n,
// ... in row-major order, so that a warp hands the functor 32 consecutive
// columns of a row (coalesced reads and writes), batch by batch, each
// batch's loads issued before its stores.
template <int BATCH, class Epi>
__device__ __forceinline__ void epilogue_rows(const float* cs, const Unit& w,
                                              const GemmShape& sh, const Epi& epi,
                                              int r0, int rows, int i, int n) {
  const int m_out = w.m0 + w.z * sh.M;
#pragma unroll 1
  for (int e0 = i; e0 < rows * BN; e0 += n * BATCH) {
    typename Epi::In in[BATCH];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int e = e0 + b * n, r = r0 + e / BN, c = e % BN;
      if (e < rows * BN && w.m0 + r < sh.M && w.n0 + c < sh.N)
        in[b] = epi.load(m_out + r, w.n0 + c);
    }
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int e = e0 + b * n, r = r0 + e / BN, c = e % BN;
      if (e < rows * BN && w.m0 + r < sh.M && w.n0 + c < sh.N)
        epi.store(m_out + r, w.n0 + c, cs[r * BN + (c ^ ((r & 7) << 2))], in[b]);
    }
  }
}

// acc[m, n] = sum_k A(m, k) * B(k, n) over each unit's k range, then
// epi.store(m', n, acc, epi.load(m', n)) for every (m, n) inside the edge,
// m' = m + z * M for split z (a split-K launch's partials stack their
// splits' rows; other launches have one split, m' = m).
// A(m, k) = A_KC ? A[m*lda + k] : A[k*lda + m]
// B_KC: B(k, n) from the converted weight behind map_b (fp32: tf32 hi,
// and lo behind map_b2; bf16); else B(k, n) = B[k*ldb + n].
template <bool A_KC, bool B_KC, class Epi, int PREC>
__global__ void __launch_bounds__(NT, 1)
sgemm_kernel(const __grid_constant__ CUtensorMap map_a,
             const __grid_constant__ CUtensorMap map_b,
             const __grid_constant__ CUtensorMap map_b2, GemmShape sh,
             Operand a, Operand b, Epi epi) {
  using R = Ring<B_KC, PREC>;
  extern __shared__ uint8_t smem_raw[];
  // aligned by an offset into the array, so that the compiler still knows
  // every access below is to shared memory (LDS / STS, not generic loads)
  uint8_t* const ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* const stg = ring + R::STAGES * R::STAGE_BYTES;   // !B_KC only
  float* const cs = reinterpret_cast<float*>(stg + R::SSTAGES * staged_bytes(PREC));
  uint64_t* const full = reinterpret_cast<uint64_t*>(cs + BM * BN);
  uint64_t* const empty = full + R::STAGES;
  uint64_t* const sfull = empty + R::STAGES;
  uint64_t* const sempty = sfull + R::SSTAGES;
  const bool copies = !a.tma || (!B_KC && !b.tma);
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      // the TMA lane's arrival, and each loader lane's cp.async arrival
      mbar_init(&full[s], 1 + (copies ? 32 : 0));
      // the consumer warps, and the stager warps
      mbar_init(&empty[s], B_KC ? 8 : 8 + 3);
    }
    for (int s = 0; s < R::SSTAGES; ++s) {
      mbar_init(&sfull[s], 3);
      mbar_init(&sempty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    int stage = 0;
    uint32_t phase = 0;
    if (warp == 0) {
      // the loader
      const uint32_t tx = (a.tma ? TILE_BYTES : 0) +
                          (B_KC ? staged_bytes(PREC) : b.tma ? TILE_BYTES : 0);
      for (int u = blockIdx.x; u < sh.units; u += gridDim.x) {
        const Unit w = unit_at(sh, u);
        for (int kt = 0; kt < w.nk; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          float* const as = reinterpret_cast<float*>(ring + stage * R::STAGE_BYTES);
          float* const bs = as + TILE_FLOATS;
          const int k0 = w.k_lo + kt * BK;
          if (!a.tma) copy_tile<A_KC>(as, a, sh.M, sh.K, w.m0, k0, lane);
          if (!B_KC && !b.tma) copy_tile<false>(bs, b, sh.N, sh.K, w.n0, k0, lane);
          if (copies) cp_async_arrive(&full[stage]);
          if (lane == 0) {
            if (tx)
              mbar_arrive_tx(&full[stage], tx);
            else
              mbar_arrive(&full[stage]);
            if (a.tma) tma_tile<A_KC>(as, &map_a, &full[stage], w.m0, k0);
            if (B_KC) {
              tma_load(bs, &map_b, &full[stage], k0, w.n0);
              if (PREC == PREC_F32)
                tma_load(bs + TILE_FLOATS, &map_b2, &full[stage], k0, w.n0);
            } else if (b.tma) {
              tma_tile<false>(bs, &map_b, &full[stage], w.n0, k0);
            }
          }
          if (++stage == R::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    } else if (!B_KC) {
      // the stagers
      int ss = 0;
      uint32_t sphase = 0;
      const int st = threadIdx.x - 32;
      for (int u = blockIdx.x; u < sh.units; u += gridDim.x) {
        const Unit w = unit_at(sh, u);
        for (int kt = 0; kt < w.nk; ++kt) {
          mbar_wait(&full[stage], phase);
          mbar_wait(&sempty[ss], sphase ^ 1);
          stage_b<PREC>(reinterpret_cast<const float*>(ring + stage * R::STAGE_BYTES) +
                            TILE_FLOATS,
                        stg + ss * staged_bytes(PREC), st);
          fence_proxy_async();
          __syncwarp();
          if (lane == 0) {
            mbar_arrive(&sfull[ss]);
            mbar_arrive(&empty[stage]);
          }
          if (++stage == R::STAGES) {
            stage = 0;
            phase ^= 1;
          }
          if (++ss == R::SSTAGES) {
            ss = 0;
            sphase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    // a consumer warpgroup: rows 64 cw .. + 63 of the block tile
    const int cw = wg - 1, tw = threadIdx.x - 128 * wg;
    const int wq = tw / 32, g = lane >> 2, t = lane & 3;
    const int ra = 64 * cw + 16 * wq + g;   // this thread's first A row
    int stage = 0, ss = 0;
    uint32_t phase = 0, sphase = 0;
    float acc[64], part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) part[i] = 0.f;
    Frag<PREC> frag;   // the current k-tile's A fragments
    if (blockIdx.x < sh.units) {
      ARegs first;
      mbar_wait(&full[0], 0);
      load_a<A_KC, PREC>(first, reinterpret_cast<const float*>(ring), ra, t);
      frag.set(first);
      if (!B_KC) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[0]);
      }
    }
    for (int u = blockIdx.x; u < sh.units; u += gridDim.x) {
      const Unit w = unit_at(sh, u);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < w.nk; ++kt) {
        int nstage = stage + 1;
        uint32_t nphase = phase;
        if (nstage == R::STAGES) {
          nstage = 0;
          nphase ^= 1;
        }
        // the next k-tile (the next unit's first, at a unit's end): its
        // loads are in flight while this k-tile's group runs
        const bool more = kt + 1 < w.nk || u + (int)gridDim.x < sh.units;
        ARegs nxt;
        if (more) {
          mbar_wait(&full[nstage], nphase);
          load_a<A_KC, PREC>(
              nxt, reinterpret_cast<const float*>(ring + nstage * R::STAGE_BYTES), ra, t);
        }
        const uint8_t* bs;
        if (B_KC) {
          bs = ring + stage * R::STAGE_BYTES + TILE_BYTES;
        } else {
          bs = stg + ss * staged_bytes(PREC);
          mbar_wait(&sfull[ss], sphase);
        }
        mma_tile<PREC>(part, frag, bs);
        wgmma_wait_all();
        fence_acc(part);
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(B_KC ? &empty[stage] : &sempty[ss]);
          if (!B_KC && more) mbar_arrive(&empty[nstage]);   // its A is read
        }
        if (!B_KC && ++ss == R::SSTAGES) {
          ss = 0;
          sphase ^= 1;
        }
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += part[i];
        if (more) frag.set(nxt);
        stage = nstage;
        phase = nphase;
      }

      // the epilogue: the accumulators go through shared memory, each
      // warpgroup its own 64 rows
      named_sync(1 + cw);   // the last unit's rows are read
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 64 * cw + 16 * wq + g + 8 * h, c = 8 * j + 2 * t;
          *reinterpret_cast<float2*>(&cs[r * BN + (c ^ ((r & 7) << 2))]) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      named_sync(1 + cw);
      epilogue_rows<EPI_BATCH>(cs, w, sh, epi, 64 * cw, 64, tw, 128);
    }
  }
}

// B of a product with a weight, converted once a call for TMA: B(k, n) =
// trans ? W[k * ld + n] : W[n * ld + k], k < K, n < N, written K-major, row
// n at n * ldk: PREC_F32 the tf32 hi (at dst) and lo (at dst + N * ldk), as
// split_tf32 splits; PREC_BF16 bf16 (nearest even). 32 x 32 tiles through
// shared memory, so that both sides are coalesced.
template <int PREC>
__global__ void prep_b_kernel(const float* __restrict__ W, int N, int K, int ld,
                              int trans, void* __restrict__ dst, int ldk) {
  __shared__ float tile[32][33];   // [k][n]
  const int n0 = blockIdx.y * 32, k0 = blockIdx.x * 32;
  for (int i = threadIdx.y; i < 32; i += 8) {
    if (trans) {
      const int k = k0 + i, n = n0 + threadIdx.x;
      if (k < K && n < N) tile[i][threadIdx.x] = W[(long long)k * ld + n];
    } else {
      const int n = n0 + i, k = k0 + threadIdx.x;
      if (k < K && n < N) tile[threadIdx.x][i] = W[(long long)n * ld + k];
    }
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int n = n0 + i, k = k0 + threadIdx.x;
    if (k >= K || n >= N) continue;
    const float x = tile[threadIdx.x][i];
    const long long o = (long long)n * ldk + k;
    if constexpr (PREC == PREC_F32) {
      uint32_t h, l;
      split_tf32(x, h, l);
      static_cast<uint32_t*>(dst)[o] = h;
      static_cast<uint32_t*>(dst)[(long long)N * ldk + o] = l;
    } else {
      unsigned short r;
      asm("cvt.rn.bf16.f32 %0, %1;\n" : "=h"(r) : "f"(x));
      static_cast<unsigned short*>(dst)[o] = r;
    }
  }
}

// ---- epilogues shared by both kernels ----
// An epilogue functor reads its inputs at (m, n) in load and writes in
// store(m, n, acc, inputs): two calls, so that the GEMM can have a batch of
// rows' loads in flight before their stores (one call that loads and then
// stores makes each load wait for the store before it, which may alias).

// C[m, n] = acc; for a split-K launch, m counts the stacked splits' rows
struct StoreEpi {
  float* C;
  int ldc;
  struct In {};
  __device__ __forceinline__ In load(int, int) const { return {}; }
  __device__ __forceinline__ void store(int m, int n, float v, In) const {
    C[(long long)m * ldc + n] = v;
  }
};

// C = act(acc + bias + sigma * wsig + ctx[m / ssz]); act < 0: none.
// sigma, wsig and ctx are null except on the split first trunk layer.
struct FwdEpi {
  float* C;
  int ldc;
  const float* bias;
  const float* sigma;     // (M,) per row
  const float* wsig;      // sigma's weight column, stride wsig_ld
  int wsig_ld;
  const float* ctx;       // (M / ssz, ctx_ld) per-item rows
  int ctx_ld, ssz;
  int act;
  struct In { float b, sw, cx; };
  __device__ __forceinline__ In load(int m, int n) const {
    In in = {bias ? bias[n] : 0.f, 0.f, 0.f};
    if (wsig) in.sw = sigma[m] * wsig[(long long)n * wsig_ld];
    if (ctx) in.cx = ctx[(long long)(m / ssz) * ctx_ld + n];
    return in;
  }
  __device__ __forceinline__ void store(int m, int n, float v, In in) const {
    if (bias) v += in.b;
    if (wsig) v += in.sw;
    if (ctx) v += in.cx;
    if (act >= 0) v = act_fwd(act, v);
    C[(long long)m * ldc + n] = v;
  }
};

// C = acc * phi'(pre), phi' from the post-activation u at the same (m, n)
struct DhEpi {
  float* C;
  int ldc;
  const float* u;
  int u_ld;
  int act;
  struct In { float u; };
  __device__ __forceinline__ In load(int m, int n) const {
    return {u[(long long)m * u_ld + n]};
  }
  __device__ __forceinline__ void store(int m, int n, float v, In in) const {
    C[(long long)m * ldc + n] = v * act_grad_from_out(act, in.u);
  }
};

// out[s, c] = sum over rows r of segment s of X[r, c] * (w ? w[r] : 1).
// Memory-bound: each of the block's 8 row lanes sums every 8th row of the
// segment with 4 loads in flight, then the lanes add in a fixed order.
__global__ void __launch_bounds__(COLSUM_COLS * COLSUM_LANES)
seg_colsum_kernel(const float* __restrict__ X, int n, int cols, int ldx,
                  int seg, const float* __restrict__ w,
                  float* __restrict__ out, int ldo) {
  __shared__ float part[COLSUM_LANES][COLSUM_COLS];
  const int col = threadIdx.x % COLSUM_COLS, lane = threadIdx.x / COLSUM_COLS;
  const int c = blockIdx.x * COLSUM_COLS + col;
  const int s = blockIdx.y;
  const int r1 = min(n, s * seg + seg);
  constexpr int STEP = COLSUM_LANES;
  float acc = 0.f;
  if (c < cols) {
    int r = s * seg + lane;
    for (; r + 3 * STEP < r1; r += 4 * STEP) {
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = X[(long long)(r + i * STEP) * ldx + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc = w ? fmaf(v[i], w[r + i * STEP], acc) : acc + v[i];
    }
    for (; r < r1; r += STEP) {
      const float v = X[(long long)r * ldx + c];
      acc = w ? fmaf(v, w[r], acc) : acc + v;
    }
  }
  part[lane][col] = acc;
  __syncthreads();
  if (lane == 0 && c < cols) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < COLSUM_LANES; ++i) t += part[i][col];
    out[(long long)s * ldo + c] = t;
  }
}

// out[m*ldo_m + n*ldo_n] = sum_s P[s*M*N + m*N + n], s in order
__global__ void reduce_splits_kernel(const float* __restrict__ P, int S, int M,
                                     int N, float* __restrict__ out, int ldo_m,
                                     int ldo_n) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long MN = (long long)M * N;
  if (idx >= MN) return;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += P[s * MN + idx];
  const int m = (int)(idx / N), nn = (int)(idx % N);
  out[(long long)m * ldo_m + (long long)nn * ldo_n] = acc;
}

__device__ float block_sum(float v) {
  __shared__ float sh[32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  v = threadIdx.x < blockDim.x / 32 ? sh[lane] : 0.f;
  if (warp == 0)
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void loss_final_kernel(const float* __restrict__ partial, int count,
                                  float inv_total, float* __restrict__ loss) {
  float acc = 0.f;
  for (int i = threadIdx.x; i < count; i += blockDim.x) acc += partial[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) loss[0] = acc * inv_total;
}

int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// k range of one split: ceil(K / splits) rounded up to BK
int split_len(int K, int splits) {
  const int kps = cdiv(cdiv(K, splits), BK) * BK;
  return kps > 0 ? kps : BK;
}

// ---- host side ----
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled through the runtime, or null
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v > 0 ? v : 132;
  }();
  return n;
}

long long g_cp_async_operands = 0;   // operands the loader copied itself
cudaError_t g_core_error = cudaSuccess;   // a GEMM the core could not launch

// A 2-D tensor map: dims (inner, outer), row stride in bytes, box (inner,
// outer); boxes past the edge read as zeros. TMA needs a 16-byte aligned
// base and row stride: false where they are not (or the driver refuses).
bool make_map(CUtensorMap* map, const void* p, CUtensorMapDataType type,
              long long inner, long long outer, long long stride_bytes,
              int box_inner, int box_outer, CUtensorMapSwizzle swizzle) {
  if (stride_bytes % 16 != 0 || (reinterpret_cast<uintptr_t>(p) & 15) != 0)
    return false;
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)stride_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(p), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a raw fp32 operand for tma_tile: rows x K, K-contiguous (one 32 x 128
// box a k-tile), or K x rows, rows contiguous (four 32 x 32 boxes)
bool make_raw_map(CUtensorMap* map, bool kc, const float* p, int ld, int rows,
                  int K) {
  return make_map(map, p, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, kc ? K : rows,
                  kc ? rows : K, 4LL * ld, 32, kc ? BM : BK,
                  CU_TENSOR_MAP_SWIZZLE_128B);
}

// row stride, in elements, of a converted weight (prep_b): 16-byte rows
int prep_ld(int prec, int K) {
  return prec == PREC_F32 ? (K + 3) / 4 * 4 : (K + 7) / 8 * 8;
}

// Launches over cdiv(K, split_len(K, splits)) <= splits splits, its
// products in PREC, one persistent block an SM. B_KC: B is a weight
// converted by prep_b (rows N of ldb = prep_ld elements); else B(k, n) =
// B[k*ldb + n]. The block needs more than the 48 KB of static shared
// memory: the first launch of each instantiation raises its limit (the
// attribute's error, if any, surfaces in the entry point's launch_status).
template <bool A_KC, bool B_KC, int PREC = PREC_F32, class Epi>
void sgemm(int M, int N, int K, int splits, const float* A, int lda,
           const void* B, int ldb, const Epi& epi, cudaStream_t stream) {
  constexpr int smem = Ring<B_KC, PREC>::SMEM;
  static const cudaError_t attr = cudaFuncSetAttribute(
      sgemm_kernel<A_KC, B_KC, Epi, PREC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  (void)attr;
  GemmShape sh;
  sh.M = M;
  sh.N = N;
  sh.K = K;
  sh.kps = split_len(K, splits);
  const int S = cdiv(K, sh.kps) > 0 ? cdiv(K, sh.kps) : 1;
  sh.tiles_m = cdiv(M, BM);
  sh.tiles_n = cdiv(N, BN);
  sh.units = sh.tiles_m * sh.tiles_n * S;
  if (M <= 0 || N <= 0 || K <= 0) return;
  CUtensorMap ma, mb, mb2;
  memset(&ma, 0, sizeof(ma));
  memset(&mb, 0, sizeof(mb));
  memset(&mb2, 0, sizeof(mb2));
  const Operand a = {A, lda, make_raw_map(&ma, A_KC, A, lda, M, K) ? 1 : 0};
  Operand b = {static_cast<const float*>(B), ldb, 0};
  if (B_KC) {
    // the converted weight always takes TMA, straight into wgmma's layout
    const bool ok =
        PREC == PREC_F32
            ? make_map(&mb, B, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, K, N, 4LL * ldb,
                       32, BN, CU_TENSOR_MAP_SWIZZLE_128B) &&
                  make_map(&mb2, static_cast<const float*>(B) + (long long)N * ldb,
                           CU_TENSOR_MAP_DATA_TYPE_FLOAT32, K, N, 4LL * ldb, 32,
                           BN, CU_TENSOR_MAP_SWIZZLE_128B)
            : make_map(&mb, B, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, K, N, 2LL * ldb,
                       32, BN, CU_TENSOR_MAP_SWIZZLE_64B);
    if (!ok) {
      if (g_core_error == cudaSuccess) g_core_error = cudaErrorNotSupported;
      return;
    }
    b.tma = 1;
  } else {
    b.tma = make_raw_map(&mb, false, b.p, ldb, N, K) ? 1 : 0;
  }
  g_cp_async_operands += !a.tma + !b.tma;
  const int grid = sh.units < sm_count() ? sh.units : sm_count();
  sgemm_kernel<A_KC, B_KC, Epi, PREC><<<grid, NT, smem, stream>>>(ma, mb, mb2,
                                                                  sh, a, b, epi);
}

// B(k, n) = trans ? W[k * ld + n] : W[n * ld + k] converted into prep for
// sgemm<..., true, PREC> (N x prep_ld(PREC, K) elements; fp32: hi then lo)
template <int PREC>
void prep_b(const float* W, int N, int K, int ld, bool trans, void* prep,
            cudaStream_t stream) {
  dim3 grid(cdiv(K, 32), cdiv(N, 32));
  prep_b_kernel<PREC><<<grid, dim3(32, 8), 0, stream>>>(W, N, K, ld, trans ? 1 : 0,
                                                        prep, prep_ld(PREC, K));
}

// A . B for B(k, n) a weight as prep_b reads it: converts it into prep, then
// runs the product with A K-contiguous
template <int PREC = PREC_F32, class Epi>
void sgemm_w(int M, int N, int K, const float* A, int lda, const float* W,
             int ld, bool trans, float* prep, const Epi& epi,
             cudaStream_t stream, int splits = 1) {
  prep_b<PREC>(W, N, K, ld, trans, prep, stream);
  sgemm<true, true, PREC>(M, N, K, splits, A, lda, prep, prep_ld(PREC, K), epi,
                          stream);
}

// the entry points' status: the first GEMM the core refused, else
// cudaGetLastError()
int launch_status() {
  const cudaError_t e = g_core_error;
  g_core_error = cudaSuccess;
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

// number of K splits of a weight-gradient GEMM: at most WGRAD_BLOCKS units
// (two a persistent block)
int wgrad_splits(int M, int N, int K) {
  const int tiles = cdiv(M, BM) * cdiv(N, BN);
  int S = WGRAD_BLOCKS / tiles;
  const int max_s = cdiv(K, 16 * BK);   // at least 16 k-tiles per split
  if (S > max_s) S = max_s;
  if (S < 1) S = 1;
  // the launch rounds the per-split range up to BK: report the real count
  // (a fixed point of the rounding, so sgemm launches exactly S splits)
  const int kS = cdiv(K, split_len(K, S));
  return kS > 0 ? kS : 1;
}

// the split-K partials of dW (out x in) = sum over rows of A^T B, with A
// (rows, out) and B (rows, in) row-major: S partials written to P, split s
// at P + s * out * in
template <int PREC = PREC_F32>
void wgrad_partials(int out, int in, int rows, int S, const float* A, int lda,
                    const float* B, int ldb, float* P, cudaStream_t stream) {
  const StoreEpi st = {P, in};
  sgemm<false, false, PREC>(out, in, rows, S, A, lda, B, ldb, st, stream);
}

int colsum_seg(int n) { return cdiv(n, n < COLSUM_SEGS ? n : COLSUM_SEGS); }

void seg_colsum(const float* X, int n, int cols, int ldx, int seg,
                const float* w, float* out, int ldo, cudaStream_t stream) {
  dim3 grid(cdiv(cols, COLSUM_COLS), cdiv(n, seg));
  seg_colsum_kernel<<<grid, COLSUM_COLS * COLSUM_LANES, 0, stream>>>(
      X, n, cols, ldx, seg, w, out, ldo);
}

void reduce_splits(const float* P, int S, int M, int N, float* out, int ldo_m,
                   int ldo_n, cudaStream_t stream) {
  const long long MN = (long long)M * N;
  reduce_splits_kernel<<<cdiv(MN, 256), 256, 0, stream>>>(P, S, M, N, out,
                                                          ldo_m, ldo_n);
}

// the column sums of X (n, cols), optionally weighted by w per row, into
// out[c * ldo_n], summed over fixed row segments through scratch
void colsum(const float* X, int n, int cols, int ldx, const float* w,
            float* scratch, float* out, int ldo_n, cudaStream_t stream) {
  const int seg = colsum_seg(n);
  seg_colsum(X, n, cols, ldx, seg, w, scratch, cols, stream);
  reduce_splits(scratch, cdiv(n, seg), 1, cols, out, 0, ldo_n, stream);
}

// floats at the front of an entry point's scratch that hold the weight of
// one product converted by prep_b, either way round (tf32 hi and lo, or
// bf16): room for any one layer
long long prep_floats(int n_layers, const int* in_dims, const int* out_dims) {
  long long need = 0;
  for (int i = 0; i < n_layers; ++i) {
    const long long f = (long long)out_dims[i] * prep_ld(PREC_F32, in_dims[i]);
    const long long t = (long long)in_dims[i] * prep_ld(PREC_F32, out_dims[i]);
    if (f > need) need = f;
    if (t > need) need = t;
  }
  return (2 * need + 63) / 64 * 64;
}

}  // namespace

extern "C" {

// dynamic shared memory of one GEMM block, B a converted weight (b_kc 1)
// or N-contiguous (0), in a precision, for the build report
int dsm_sgemm_smem_bytes(int b_kc, int prec) {
  return sgemm_smem_bytes(b_kc != 0, prec);
}

// operands this library's GEMM launches copied with cp.async since it was
// loaded (a base or row stride TMA cannot take)
long long dsm_sgemm_cp_async_operands() { return g_cp_async_operands; }

// The GEMM core alone, for the card tests and chip_smoke.py: C (splits'
// partials stacked, cdiv(K, split_len(K, splits)) x M x N, row-major) =
// A(m, k) * B(k, n) over each split's k range, in prec, in the two layouts
// the kernels use: kc 1, A and B K-contiguous (B[n*ldb + k], a weight,
// converted first into scratch: 2 x N x ceil4(K) floats; the forward
// layout) or kc 0, both M/N-contiguous (A[k*lda + m], B[k*ldb + n]; the
// weight gradients' split-K layout). Returns the launch status; another
// prec returns cudaErrorInvalidValue.
int dsm_sgemm_probe(int kc, int prec, int M, int N, int K, int splits,
                    const float* A, int lda, const float* B, int ldb, float* C,
                    float* scratch, cudaStream_t stream) {
  const StoreEpi st = {C, N};
  if (prec != PREC_F32 && prec != PREC_BF16) return (int)cudaErrorInvalidValue;
  if (kc && prec == PREC_F32)
    sgemm_w<PREC_F32>(M, N, K, A, lda, B, ldb, false, scratch, st, stream, splits);
  else if (kc)
    sgemm_w<PREC_BF16>(M, N, K, A, lda, B, ldb, false, scratch, st, stream, splits);
  else if (prec == PREC_F32)
    sgemm<false, false, PREC_F32>(M, N, K, splits, A, lda, B, ldb, st, stream);
  else
    sgemm<false, false, PREC_BF16>(M, N, K, splits, A, lda, B, ldb, st, stream);
  return launch_status();
}

}  // extern "C"
