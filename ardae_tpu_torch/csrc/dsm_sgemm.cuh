// Shared core of the hand-written DSM kernels (fused_dsm.cu and
// fused_dsm_grad.cu), fp32, for NVIDIA Hopper (sm_90a):
//  * one tiled SGEMM (128x128x8 block tile, 8x8 outputs a thread read from
//    shared memory as float4s, two shared buffers with the next tile's
//    global loads in flight, ragged edges masked) whose epilogue is a
//    functor, so each chain fuses its own bias / activation / product;
//  * deterministic reductions without atomics: split-K partials summed in a
//    fixed order, column sums over fixed row segments, fixed-grid block sums;
//  * the activations phi and the factors phi' and phi''/phi' taken from the
//    post-activation u = phi(pre).
// Each including file gets its own copy (anonymous namespace).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 8, NT = 256, PAD = 4;
constexpr int LOSS_BLOCKS = 264;   // two blocks per SM of an H100 SXM
constexpr int COLSUM_SEGS = 64;    // row segments of a split column sum
constexpr int COLSUM_COLS = 32;    // a column-sum block: 32 columns (a warp
constexpr int COLSUM_LANES = 8;    // reads 128 B of a row) x 8 row lanes

enum Act { ACT_SOFTPLUS = 0, ACT_RELU = 1, ACT_TANH = 2 };

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

// One operand tile (BK x 128 of A or B) staged through registers: each
// thread holds 4 consecutive elements along the operand's contiguous axis,
// read as one float4 where the launch found the operand 16-byte aligned
// (vec) and the 4 lie inside the edge, else as masked scalars.
// KC (K-contiguous): thread t takes row t/2, k = 4*(t%2) .. +3.
// else (M/N-contiguous): thread t takes k = t/32, rows 4*(t%32) .. +3.
template <bool KC>
__device__ __forceinline__ void load_tile(const float* __restrict__ X, int ld,
                                          int rows, int r0, int k0, int k_hi,
                                          bool vec, float (&v)[4]) {
  const int t = threadIdx.x;
  if (KC) {
    const int r = r0 + (t >> 1), k = k0 + (t & 1) * 4;
    const float* p = X + (long long)r * ld + k;
    if (vec && r < rows && k + 3 < k_hi) {
      const float4 q = *reinterpret_cast<const float4*>(p);
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = (r < rows && k + i < k_hi) ? p[i] : 0.f;
    }
  } else {
    const int k = k0 + (t >> 5), r = r0 + (t & 31) * 4;
    const float* p = X + (long long)k * ld + r;
    if (vec && k < k_hi && r + 3 < rows) {
      const float4 q = *reinterpret_cast<const float4*>(p);
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = (k < k_hi && r + i < rows) ? p[i] : 0.f;
    }
  }
}

template <bool KC>
__device__ __forceinline__ void store_tile(float (*S)[BM + PAD],
                                           const float (&v)[4]) {
  const int t = threadIdx.x;
  if (KC) {
    const int r = t >> 1, k = (t & 1) * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) S[k + i][r] = v[i];
  } else {
    *reinterpret_cast<float4*>(&S[t >> 5][(t & 31) * 4]) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

// acc[m, n] = sum_k A(m, k) * B(k, n) over this split's k range (blockIdx.z),
// then epi(m, n, acc) for every (m, n) inside the edge.
// A(m, k) = A_KC ? A[m*lda + k] : A[k*lda + m]
// B(k, n) = B_KC ? B[n*ldb + k] : B[k*ldb + n]
// Each thread owns an 8x8 block of C: rows {4ty..4ty+3, 64+4ty..64+4ty+3},
// columns likewise with tx, read from shared memory as float4s. Two shared
// buffers: the next k-tile's global loads are in flight while this one is
// multiplied.
template <bool A_KC, bool B_KC, class Epi>
__global__ void __launch_bounds__(NT)
sgemm_kernel(int M, int N, int K, int k_per_split,
             const float* __restrict__ A, int lda, bool a_vec,
             const float* __restrict__ B, int ldb, bool b_vec, Epi epi) {
  __shared__ __align__(16) float As[2][BK][BM + PAD];
  __shared__ __align__(16) float Bs[2][BK][BN + PAD];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_lo = blockIdx.z * k_per_split;
  const int k_hi = min(K, k_lo + k_per_split);
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float ra[4], rb[4];
  if (n_tiles > 0) {
    load_tile<A_KC>(A, lda, M, m0, k_lo, k_hi, a_vec, ra);
    load_tile<B_KC>(B, ldb, N, n0, k_lo, k_hi, b_vec, rb);
    store_tile<A_KC>(As[0], ra);
    store_tile<B_KC>(Bs[0], rb);
  }
  __syncthreads();
  for (int t = 0; t < n_tiles; ++t) {
    const int cur = t & 1;
    const bool more = t + 1 < n_tiles;
    if (more) {
      const int k0 = k_lo + (t + 1) * BK;
      load_tile<A_KC>(A, lda, M, m0, k0, k_hi, a_vec, ra);
      load_tile<B_KC>(B, ldb, N, n0, k0, k_hi, b_vec, rb);
    }
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][k][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][k][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][k][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][k][64 + 4 * tx]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) {
      store_tile<A_KC>(As[cur ^ 1], ra);
      store_tile<B_KC>(Bs[cur ^ 1], rb);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
      if (n >= N) continue;
      epi(m, n, acc[i][j]);
    }
  }
}

// ---- epilogues shared by both kernels ----

// C[split][m, n] = acc: one split-K partial per blockIdx.z
struct StoreEpi {
  float* C;
  int ldc;
  long long split_stride;
  __device__ __forceinline__ void operator()(int m, int n, float v) const {
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
  __device__ __forceinline__ void operator()(int m, int n, float v) const {
    if (bias) v += bias[n];
    if (wsig) v += sigma[m] * wsig[(long long)n * wsig_ld];
    if (ctx) v += ctx[(long long)(m / ssz) * ctx_ld + n];
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
  __device__ __forceinline__ void operator()(int m, int n, float v) const {
    C[(long long)m * ldc + n] =
        v * act_grad_from_out(act, u[(long long)m * u_ld + n]);
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

// float4 loads need a 16-byte aligned base and a leading dimension that
// keeps every row (or k-row) 16-byte aligned
bool vec_ok(const float* p, int ld) {
  return ld % 4 == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// launches over cdiv(K, split_len(K, splits)) <= splits splits
template <bool A_KC, bool B_KC, class Epi>
void sgemm(int M, int N, int K, int splits, const float* A, int lda,
           const float* B, int ldb, const Epi& epi, cudaStream_t stream) {
  const int kps = split_len(K, splits);
  dim3 grid(cdiv(N, BN), cdiv(M, BM), cdiv(K, kps) > 0 ? cdiv(K, kps) : 1);
  sgemm_kernel<A_KC, B_KC, Epi><<<grid, NT, 0, stream>>>(
      M, N, K, kps, A, lda, vec_ok(A, lda), B, ldb, vec_ok(B, ldb), epi);
}

// number of K splits of a weight-gradient SGEMM: enough blocks for ~2 waves
int wgrad_splits(int M, int N, int K) {
  const int tiles = cdiv(M, BM) * cdiv(N, BN);
  int S = cdiv(2 * 132, tiles);
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
void wgrad_partials(int out, int in, int rows, int S, const float* A, int lda,
                    const float* B, int ldb, float* P, cudaStream_t stream) {
  const StoreEpi st = {P, in, (long long)out * in};
  sgemm<false, false>(out, in, rows, S, A, lda, B, ldb, st, stream);
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

}  // namespace
