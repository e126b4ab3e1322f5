// Shared core of the hand-written DSM kernels (fused_dsm.cu and
// fused_dsm_grad.cu) for NVIDIA Hopper (sm_90a):
//  * one tiled GEMM on the tensor cores in one of two precisions, a
//    template parameter (Prec). PREC_F32, fp32-accurate, 3xTF32: each fp32 operand x is
//    split in registers as hi = tf32(x), lo = tf32(x - hi) (rounded as
//    cvt.rna.tf32.f32 rounds), and warp-level mma.sync.m16n8k8 TF32
//    products lo*hi + hi*lo + hi*hi, small terms first, sum into an fp32
//    accumulator (about 21 of fp32's 24 bits kept, at up to 495 / 3 TFLOP/s
//    against 67 on the CUDA cores). A 128x128x32 block tile of 8 warps (each
//    64x32), a ring of STAGES k-tiles in dynamic shared memory filled with
//    cp.async (16-byte copies where an operand's rows are 16-byte aligned,
//    else 4-byte copies), ragged edges zero-filled on load and masked on
//    store; its epilogue is a functor, so each chain fuses its own bias /
//    activation / product, fed row by row from shared memory. PREC_BF16
//    (the TPU grad kernels' bf16 compute mode): the same tiles, ring and
//    epilogue, but each fp32 operand is rounded to bf16 (to nearest even,
//    cvt.rn.bf16x2.f32, two k a register) as its fragment is read from
//    shared memory, and one mma.sync.m16n8k16 bf16 product a fragment
//    sums into the same fp32 accumulators (989 TFLOP/s bf16 peak);
//  * deterministic reductions without atomics: split-K partials summed in a
//    fixed order, column sums over fixed row segments, fixed-grid block sums;
//  * the activations phi and the factors phi' and phi''/phi' taken from the
//    post-activation u = phi(pre).
// Each including file gets its own copy (anonymous namespace).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3;
constexpr int WM = 64, WN = 32;     // warp tile
constexpr int NT = 32 * (BM / WM) * (BN / WN);   // 8 warps, one block an
                                                 // SM (~200 registers)
constexpr int KC_LD = BK + 8;       // K-contiguous tile: [rows][40] floats
constexpr int C_LD = BN + 8;        // epilogue staging: [BM][136] floats
constexpr int EPI_BATCH = 16;       // epilogue rows a thread loads at once
constexpr int LOSS_BLOCKS = 264;    // two blocks per SM of an H100 SXM
constexpr int WGRAD_BLOCKS = 264;   // weight-gradient blocks: two waves
constexpr int COLSUM_SEGS = 64;     // row segments of a split column sum
constexpr int COLSUM_COLS = 32;     // a column-sum block: 32 columns (a warp
constexpr int COLSUM_LANES = 8;     // reads 128 B of a row) x 8 row lanes

enum Act { ACT_SOFTPLUS = 0, ACT_RELU = 1, ACT_TANH = 2 };
// the products' precision: fp32-accurate (3xTF32) or operands in bf16
enum Prec { PREC_F32 = 0, PREC_BF16 = 1 };

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

// One operand's k-tile in shared memory, for an operand of `rows` rows (BM
// for A, BN for B). The fragments read physical k = 2t and 2t + 1 of each
// 8-deep step for the mma's k slots t and t + 4 (lane t = lane % 4,
// g = lane / 4; any order of k serves, as long as A and B share it), and
// the tiles are padded so that a warp's fragment reads hit 32 distinct
// banks: K-contiguous [r][k], one 8-byte read of k 2t, 2t + 1 per row, banks
// 8g + 2t (row stride 40 floats); M/N-contiguous [k][r], banks 8t + g (row
// stride rows + 4, which is 4 mod 32). Rows stay 16-byte aligned for the
// 16-byte copies.
__host__ __device__ constexpr int mn_ld(int rows) { return rows + 4; }

__host__ __device__ constexpr int tile_floats(bool kc, int rows) {
  return kc ? rows * KC_LD : BK * mn_ld(rows);
}

__host__ __device__ constexpr int sgemm_smem_bytes(bool a_kc, bool b_kc) {
  return STAGES * (tile_floats(a_kc, BM) + tile_floats(b_kc, BN)) * 4;
}

static_assert(BM % WM == 0 && BN % WN == 0 && BM % 32 == 0 && BN % 32 == 0,
              "warp tiles cover the block tile");
static_assert(BM * C_LD <= STAGES * (BK * mn_ld(BM) + BK * mn_ld(BN)),
              "the epilogue's staging tile fits in the smallest ring");
static_assert(BM % (EPI_BATCH * (NT / BN)) == 0, "whole epilogue batches");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copy `bytes` (16 or 4) from global src to shared dst, reading only the
// first src_bytes and zero-filling the rest
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage one operand's k-tile (k0 .. k0 + BK) of ROWS rows into shared
// memory S. KC (K-contiguous): S[r][k] = X[(r0 + r) * ld + k0 + k]; else
// S[k][r] = X[(k0 + k) * ld + r0 + r]. Each thread copies ROWS * BK / 4 / NT
// chunks of 4 floats along the contiguous axis, STEP smem rows apart. A tile
// inside the edge whose operand is 16-byte aligned (vec) takes one 16-byte
// copy a chunk and no test; at the edge each chunk is zero-filled past
// (rows, k_hi), so the products there add 0, and an operand that is not
// 16-byte aligned takes four 4-byte copies a chunk.
template <bool KC, int ROWS>
__device__ __forceinline__ void load_tile(float* S, const float* __restrict__ X,
                                          int ld, int rows, int r0, int k0,
                                          int k_hi, bool vec) {
  constexpr int CHUNKS = ROWS * BK / 4 / NT;
  constexpr int ROW_CHUNKS = KC ? BK / 4 : ROWS / 4;   // chunks a smem row
  constexpr int STEP = NT / ROW_CHUNKS;
  constexpr int LD = KC ? KC_LD : mn_ld(ROWS);
  static_assert(CHUNKS * NT * 4 == ROWS * BK && NT % ROW_CHUNKS == 0,
                "whole chunks a thread");
  const int outer = threadIdx.x / ROW_CHUNKS;
  const int inner = threadIdx.x % ROW_CHUNKS * 4;
  float* const dst = S + outer * LD + inner;
  // (outer, inner) = (row, k) if KC else (k, row)
  const int o = (KC ? r0 : k0) + outer, o_hi = KC ? rows : k_hi;
  const int a = (KC ? k0 : r0) + inner, a_hi = KC ? k_hi : rows;
  const float* const src = X + (long long)o * ld + a;
  const long long src_step = (long long)STEP * ld;
  if (vec && r0 + ROWS <= rows && k0 + BK <= k_hi) {
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i)
      cp_async16(dst + i * STEP * LD, src + i * src_step, 16);
    return;
  }
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const bool row_in = o + i * STEP < o_hi;
    const float* si = src + i * src_step;
    float* di = dst + i * STEP * LD;
    if (vec) {
      const int n = row_in ? min(4, max(0, a_hi - a)) : 0;
      cp_async16(di, n > 0 ? si : X, 4 * n);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = row_in && a + j < a_hi;
        cp_async4(di + j, in ? si + j : X, in ? 4 : 0);
      }
    }
  }
}

// x = hi + lo to ~22 bits. hi = tf32(x) and lo = tf32(x - hi) (x - hi is
// exact), each rounded to nearest with ties away from zero on the 13
// mantissa bits TF32 drops: the rounding of cvt.rna.tf32.f32, written as an
// integer add and mask because ptxas expands cvt.rna into four instructions
// (an inf test, add, select, mask; measured ~10 % slower products). lo
// keeps its low 13 bits, which the tensor cores do not read.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// d = a (16x8, row) * b (8x8, col) + c in TF32, fp32 accumulate. Not
// volatile: the compiler interleaves independent products.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_tf32_first(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  const float z = 0.f;
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(z));
}

// Two fp32 values rounded to the nearest bf16 (ties to even) and packed in
// one register, lo in the low half: the lower k of a fragment's pair
// (cvt.rn.bf16x2.f32 puts its first source in the upper half).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// d = a (16x16, row) * b (16x8, col) + d in bf16, fp32 accumulate. Lane
// (g = lane / 4, t = lane % 4) holds a = {(g, 2t..2t+1), (g + 8, 2t..2t+1),
// (g, 2t+8..2t+9), (g + 8, 2t+8..2t+9)} and b = {(2t..2t+1, g), (2t+8..2t+9,
// g)}, (row, k) and (k, col) pairs, the lower k in the low half; d as the
// TF32 product's (rows g and g + 8, columns 2t and 2t + 1).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[m, n] = sum_k A(m, k) * B(k, n) over this split's k range (blockIdx.z),
// then epi.store(m, n, acc, epi.load(m, n)) for every (m, n) inside the edge.
// A(m, k) = A_KC ? A[m*lda + k] : A[k*lda + m]
// B(k, n) = B_KC ? B[n*ldb + k] : B[k*ldb + n]
// Warp w owns rows 64 (w / 4) .. +63 and columns 32 (w % 4) .. +31 of the
// block tile: 4 x 4 m16n8 accumulators, lane (g = lane / 4, t = lane % 4)
// holding rows g and g + 8, columns 2t and 2t + 1 of each. The ring keeps
// STAGES - 1 k-tiles in flight while one is multiplied; one barrier a tile.
// The tensor cores round their fp32 accumulation toward zero, which over a
// long k range (a weight gradient's ~5,000 rows a split) biases the sum: so
// each k-tile's 12 products a term go into a fresh accumulator, added to the
// running sum with a round-to-nearest fp32 add. PREC_BF16 reads the same
// shared-memory words, k = 2t, 2t + 1, 2t + 8 and 2t + 9 of each 16-deep
// step (the bf16 fragment's own k order), rounds them to bf16 and takes 2
// products a k-tile into the fresh accumulator.
template <bool A_KC, bool B_KC, class Epi, int PREC>
__global__ void __launch_bounds__(NT, 1)
sgemm_kernel(int M, int N, int K, int k_per_split,
             const float* __restrict__ A, int lda, bool a_vec,
             const float* __restrict__ B, int ldb, bool b_vec, Epi epi) {
  extern __shared__ __align__(16) float smem[];
  constexpr int A_FL = tile_floats(A_KC, BM), B_FL = tile_floats(B_KC, BN);
  constexpr int A_LD = mn_ld(BM), B_LD = mn_ld(BN);   // M/N-contiguous tiles
  constexpr int MI = WM / 16, NJ = WN / 8;
  float* const As = smem;
  float* const Bs = smem + STAGES * A_FL;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / (BN / WN)) * WM, wn = (warp % (BN / WN)) * WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_lo = blockIdx.z * k_per_split;
  const int k_hi = min(K, k_lo + k_per_split);
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;

  float acc[MI][NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) {
      load_tile<A_KC, BM>(As + s * A_FL, A, lda, M, m0, k_lo + s * BK, k_hi,
                          a_vec);
      load_tile<B_KC, BN>(Bs + s * B_FL, B, ldb, N, n0, k_lo + s * BK, k_hi,
                          b_vec);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < n_tiles; ++kt) {
    // tile kt has landed; every warp is done with tile kt - 1, whose slot
    // the next copy refills
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = kt + STAGES - 1;
    if (nxt < n_tiles) {
      const int slot = nxt % STAGES;
      load_tile<A_KC, BM>(As + slot * A_FL, A, lda, M, m0, k_lo + nxt * BK,
                          k_hi, a_vec);
      load_tile<B_KC, BN>(Bs + slot * B_FL, B, ldb, N, n0, k_lo + nxt * BK,
                          k_hi, b_vec);
    }
    cp_async_commit();
    const float* as = As + (kt % STAGES) * A_FL;
    const float* bs = Bs + (kt % STAGES) * B_FL;
    float part[MI][NJ][4];
    if constexpr (PREC == PREC_BF16) {
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) part[i][j][q] = 0.f;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        const int k0 = kk + 2 * t;   // register 0 holds k0, k0 + 1; 1 (B) or
                                     // 2, 3 (A) hold k0 + 8, k0 + 9
        uint32_t bb[NJ][2], ab[MI][4];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int c = wn + 8 * j + g;
          float b[4];
          if (B_KC) {
            const float2 lo = *reinterpret_cast<const float2*>(&bs[c * KC_LD + k0]);
            const float2 hi = *reinterpret_cast<const float2*>(&bs[c * KC_LD + k0 + 8]);
            b[0] = lo.x;
            b[1] = lo.y;
            b[2] = hi.x;
            b[3] = hi.y;
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              b[q] = bs[(k0 + (q & 1) + 8 * (q >> 1)) * B_LD + c];
          }
          bb[j][0] = pack_bf16x2(b[0], b[1]);
          bb[j][1] = pack_bf16x2(b[2], b[3]);
        }
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // registers h (row g + 8h, k0 pair) and h + 2 (its k0 + 8 pair)
            const int r = wm + 16 * i + g + 8 * h;
            float a[4];
            if (A_KC) {
              const float2 lo = *reinterpret_cast<const float2*>(&as[r * KC_LD + k0]);
              const float2 hi = *reinterpret_cast<const float2*>(&as[r * KC_LD + k0 + 8]);
              a[0] = lo.x;
              a[1] = lo.y;
              a[2] = hi.x;
              a[3] = hi.y;
            } else {
#pragma unroll
              for (int q = 0; q < 4; ++q)
                a[q] = as[(k0 + (q & 1) + 8 * (q >> 1)) * A_LD + r];
            }
            ab[i][h] = pack_bf16x2(a[0], a[1]);
            ab[i][h + 2] = pack_bf16x2(a[2], a[3]);
          }
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) mma_bf16(part[i][j], ab[i], bb[j]);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 8) {
        const int k0 = kk + 2 * t;   // physical k of slot t; k0 + 1 is slot t + 4
        uint32_t bh[NJ][2], bl[NJ][2], ah[MI][4], al[MI][4];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int c = wn + 8 * j + g;
          float b[2];
          if (B_KC) {
            const float2 v = *reinterpret_cast<const float2*>(&bs[c * KC_LD + k0]);
            b[0] = v.x;
            b[1] = v.y;
          } else {
            b[0] = bs[k0 * B_LD + c];
            b[1] = bs[(k0 + 1) * B_LD + c];
          }
#pragma unroll
          for (int q = 0; q < 2; ++q) split_tf32(b[q], bh[j][q], bl[j][q]);
        }
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          // a0 (row g, slot t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
          float a[4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = wm + 16 * i + g + 8 * h;
            if (A_KC) {
              const float2 v = *reinterpret_cast<const float2*>(&as[r * KC_LD + k0]);
              a[h] = v.x;
              a[h + 2] = v.y;
            } else {
              a[h] = as[k0 * A_LD + r];
              a[h + 2] = as[(k0 + 1) * A_LD + r];
            }
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) split_tf32(a[q], ah[i][q], al[i][q]);
        }
        // small terms first; each pass is 16 independent products
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            if (kk == 0)
              mma_tf32_first(part[i][j], al[i], bh[j]);
            else
              mma_tf32(part[i][j], al[i], bh[j]);
          }
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) mma_tf32(part[i][j], ah[i], bl[j]);
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) mma_tf32(part[i][j], ah[i], bh[j]);
      }
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] += part[i][j][q];
  }

  // Epilogue: the accumulators go through shared memory (the ring is idle
  // now), so that each warp hands the functor 32 consecutive columns of one
  // row: coalesced reads and writes, and a few copies of the functor's code
  // instead of 64 (64 inlined copies overflowed the instruction cache).
  cp_async_wait<0>();
  __syncthreads();
  float* const Cs = smem;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(
            &Cs[(wm + 16 * i + g + 8 * h) * C_LD + wn + 8 * j + 2 * t]) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
  __syncthreads();
  // A thread issues EPI_BATCH rows' loads before their stores, so that they
  // are in flight together instead of each waiting out the one before.
  const int c = threadIdx.x % BN, n = n0 + c;
  if (n >= N) return;
#pragma unroll 1
  for (int r0 = threadIdx.x / BN; r0 < BM; r0 += EPI_BATCH * (NT / BN)) {
    typename Epi::In in[EPI_BATCH];
#pragma unroll
    for (int b = 0; b < EPI_BATCH; ++b) {
      const int m = m0 + r0 + b * (NT / BN);
      if (m < M) in[b] = epi.load(m, n);
    }
#pragma unroll
    for (int b = 0; b < EPI_BATCH; ++b) {
      const int r = r0 + b * (NT / BN);
      if (m0 + r < M) epi.store(m0 + r, n, Cs[r * C_LD + c], in[b]);
    }
  }
}

// ---- epilogues shared by both kernels ----
// An epilogue functor reads its inputs at (m, n) in load and writes in
// store(m, n, acc, inputs): two calls, so that the GEMM can have a batch of
// rows' loads in flight before their stores (one call that loads and then
// stores makes each load wait for the store before it, which may alias).

// C[split][m, n] = acc: one split-K partial per blockIdx.z
struct StoreEpi {
  float* C;
  int ldc;
  long long split_stride;
  struct In {};
  __device__ __forceinline__ In load(int, int) const { return {}; }
  __device__ __forceinline__ void store(int m, int n, float v, In) const {
    C[(long long)blockIdx.z * split_stride + (long long)m * ldc + n] = v;
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

// 16-byte copies need a 16-byte aligned base and a leading dimension that
// keeps every row (or k-row) 16-byte aligned; other operands take 4-byte ones
bool vec_ok(const float* p, int ld) {
  return ld % 4 == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// launches over cdiv(K, split_len(K, splits)) <= splits splits, its
// products in PREC. The ring needs more than the 48 KB of static shared
// memory: the first launch of each instantiation raises its limit (the
// attribute's error, if any, surfaces in the entry point's
// cudaGetLastError).
template <bool A_KC, bool B_KC, int PREC = PREC_F32, class Epi>
void sgemm(int M, int N, int K, int splits, const float* A, int lda,
           const float* B, int ldb, const Epi& epi, cudaStream_t stream) {
  constexpr int smem = sgemm_smem_bytes(A_KC, B_KC);
  static const cudaError_t attr = cudaFuncSetAttribute(
      sgemm_kernel<A_KC, B_KC, Epi, PREC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  (void)attr;
  const int kps = split_len(K, splits);
  dim3 grid(cdiv(N, BN), cdiv(M, BM), cdiv(K, kps) > 0 ? cdiv(K, kps) : 1);
  sgemm_kernel<A_KC, B_KC, Epi, PREC><<<grid, NT, smem, stream>>>(
      M, N, K, kps, A, lda, vec_ok(A, lda), B, ldb, vec_ok(B, ldb), epi);
}

// number of K splits of a weight-gradient GEMM: at most WGRAD_BLOCKS blocks
// (two waves of one block an SM; a few more would start a third)
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
// (rows, out) and B (rows, in) row-major: S partials written to P
template <int PREC = PREC_F32>
void wgrad_partials(int out, int in, int rows, int S, const float* A, int lda,
                    const float* B, int ldb, float* P, cudaStream_t stream) {
  const StoreEpi st = {P, in, (long long)out * in};
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

// out[r * ldo + c] = W[r * ld + c], c < cols
__global__ void pack_cols_kernel(const float* __restrict__ W, int rows,
                                 int cols, int ld, float* __restrict__ out,
                                 int ldo) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)rows * cols) return;
  const int r = (int)(i / cols), c = (int)(i % cols);
  out[(long long)r * ldo + c] = W[(long long)r * ld + c];
}

// leading dimension of a packed copy: rows 16-byte aligned
int pack_ld(int cols) { return (cols + 3) / 4 * 4; }

// floats at the front of an entry point's scratch that hold the packed
// copy of the split layer's W[:, :in] (its sigma column makes its stride
// in + 1, which no 16-byte copy can read): room for any one layer
long long pack_floats(int n_layers, const int* in_dims, const int* out_dims) {
  long long need = 0;
  for (int i = 0; i < n_layers; ++i) {
    const long long f = (long long)out_dims[i] * pack_ld(in_dims[i]);
    if (f > need) need = f;
  }
  return (need + 63) / 64 * 64;
}

// the first cols columns of W (rows x ld) into out, stride pack_ld(cols)
void pack_cols(const float* W, int rows, int cols, int ld, float* out,
               cudaStream_t stream) {
  pack_cols_kernel<<<cdiv((long long)rows * cols, 256), 256, 0, stream>>>(
      W, rows, cols, ld, out, pack_ld(cols));
}

}  // namespace

// dynamic shared memory of one GEMM block, for the build report
extern "C" int dsm_sgemm_smem_bytes(int a_kc, int b_kc) {
  return sgemm_smem_bytes(a_kc != 0, b_kc != 0);
}
