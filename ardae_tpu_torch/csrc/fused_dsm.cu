// Fused denoising-score-matching loss of the res-style conditional AR-DAE,
// forward and backward, fp32, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of ardae_tpu/ops/fused_dsm.py:
//   _fwd_kernel (:123)  ->  fused_dsm_fwd below
//   _bwd_kernel (:139)  ->  fused_dsm_bwd below
//
// The chain, for n = bsz * ssz rows (item of a row = row / ssz):
//   h_0   = xbar                                        (n, d)
//   h_i+1 = act(h_i @ W_i^T + b_i)                      encoder layers
//   h_l0+1= act(h_l0 @ W_l0[:, :in]^T + sigma * W_l0[:, in] + b_l0
//               + ctx_l0[row / ssz])                    split first trunk layer
//   ...   = act(h @ W^T + b)                            hidden layers
//   r     = h_L-1 @ W_L-1^T + b_L-1                     output layer, (n, d)
//   loss  = mean((sigma * r + eps)^2)
// Weights are torch-layout (out, ld); l0's sigma column is its last column.
//
// Design on this card (what bounds it, and what the design does about it):
//  * fp32 throughout, on the CUDA cores (no TF32, no tensor cores): the
//    products are bound by the ~67 TFLOP/s fp32 FMA rate. At the flagship
//    shape (n = 80,000, d = 32, h = 512, 5 encoder + l0 + 4 hidden + out)
//    the forward is ~0.38 TFLOP and the backward ~0.75 TFLOP.
//  * One tiled SGEMM template (128x128x8 block tile, 8x8 outputs a thread
//    read from shared memory as float4s, two shared buffers with the next
//    tile's global loads in flight, ragged edges masked) with three
//    operand layouts and fused epilogues: forward (bias, sigma column,
//    per-item ctx row, activation), backward input gradient (times phi'),
//    and weight gradient.
//  * Workspace, not recompute: the forward writes every hidden post-
//    activation to a global workspace ((layers-1) x n x h fp32, 1.6 GB at the
//    flagship); the backward reads it and takes phi' from the post-activation
//    (softplus: 1 - exp(-h); relu: h > 0; tanh: 1 - h^2). This spends HBM
//    bytes (~4 GB/update, ~1.3 ms at 3.35 TB/s) to save the third of the
//    FLOPs a recomputing backward would repeat.
//  * Deterministic reductions, no atomics: the TPU kernel accumulated dW, db
//    and the loss over a sequential grid. Here dW is a split-K SGEMM whose
//    splits each write a partial to scratch, then one pass sums the splits
//    in a fixed order; db, sigma's column and d/d(ctx_l0) are column sums
//    over fixed row segments (one segment per item for ctx_l0, which is thus
//    reduced to (bsz, h) in the kernel); the loss is a fixed-grid block
//    reduction and one final block. Results are bitwise reproducible run to
//    run; they differ from a CPU or cuBLAS sum only by summation order.
//  * The upstream cotangent g is read from device memory and folded into
//    d loss / d r, so every gradient comes out already scaled by it.
//
// Plain C interface, loaded with ctypes; every entry point launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 8, NT = 256, PAD = 4;
constexpr int LOSS_BLOCKS = 264;   // two blocks per SM of an H100 SXM
constexpr int COLSUM_SEGS = 64;    // row segments of a split column sum
constexpr int COLSUM_THREADS = 128;

enum Act { ACT_SOFTPLUS = 0, ACT_RELU = 1, ACT_TANH = 2 };
enum Epi { EPI_FWD = 0, EPI_DH = 1, EPI_STORE = 2 };

__device__ __forceinline__ float act_fwd(int act, float v) {
  if (act == ACT_SOFTPLUS) return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
  if (act == ACT_RELU) return fmaxf(v, 0.f);
  return tanhf(v);
}

// phi'(pre) from the post-activation h = phi(pre)
__device__ __forceinline__ float act_grad_from_out(int act, float h) {
  if (act == ACT_SOFTPLUS) return -expm1f(-h);
  if (act == ACT_RELU) return h > 0.f ? 1.f : 0.f;
  return 1.f - h * h;
}

struct EpiParams {
  const float* bias;      // (N,) or null
  const float* sigma;     // (M,) per row, or null
  const float* wsig;      // sigma's weight column, stride wsig_ld, or null
  int wsig_ld;
  const float* ctx;       // (M / ssz, ctx_ld) per-item rows, or null
  int ctx_ld, ssz;
  const float* hin;       // EPI_DH: post-activation whose phi' scales acc
  int hin_ld;
  int act;                // -1: none
};

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

// C[m, n] = sum_k A(m, k) * B(k, n) over this split's k range, then epilogue.
// A(m, k) = A_KC ? A[m*lda + k] : A[k*lda + m]
// B(k, n) = B_KC ? B[n*ldb + k] : B[k*ldb + n]
// Each thread owns an 8x8 block of C: rows {4ty..4ty+3, 64+4ty..64+4ty+3},
// columns likewise with tx, read from shared memory as float4s. Two shared
// buffers: the next k-tile's global loads are in flight while this one is
// multiplied.
template <bool A_KC, bool B_KC, int EPI>
__global__ void __launch_bounds__(NT)
sgemm_kernel(int M, int N, int K, int k_per_split,
             const float* __restrict__ A, int lda, bool a_vec,
             const float* __restrict__ B, int ldb, bool b_vec,
             float* __restrict__ C, int ldc, long long c_split_stride,
             EpiParams ep) {
  __shared__ __align__(16) float As[2][BK][BM + PAD];
  __shared__ __align__(16) float Bs[2][BK][BN + PAD];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_lo = blockIdx.z * k_per_split;
  const int k_hi = min(K, k_lo + k_per_split);
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;
  C += (long long)blockIdx.z * c_split_stride;

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
      float v = acc[i][j];
      if (EPI == EPI_FWD) {
        if (ep.bias) v += ep.bias[n];
        if (ep.wsig) v += ep.sigma[m] * ep.wsig[(long long)n * ep.wsig_ld];
        if (ep.ctx) v += ep.ctx[(long long)(m / ep.ssz) * ep.ctx_ld + n];
        if (ep.act >= 0) v = act_fwd(ep.act, v);
      } else if (EPI == EPI_DH) {
        v *= act_grad_from_out(ep.act, ep.hin[(long long)m * ep.hin_ld + n]);
      }
      C[(long long)m * ldc + n] = v;
    }
  }
}

// out[s, c] = sum over rows r of segment s of X[r, c] * (w ? w[r] : 1)
__global__ void seg_colsum_kernel(const float* __restrict__ X, int n, int cols,
                                  int ldx, int seg, const float* __restrict__ w,
                                  float* __restrict__ out, int ldo) {
  const int c = blockIdx.x * COLSUM_THREADS + threadIdx.x;
  const int s = blockIdx.y;
  if (c >= cols) return;
  const int r0 = s * seg, r1 = min(n, r0 + seg);
  float acc = 0.f;
  for (int r = r0; r < r1; ++r) {
    const float v = X[(long long)r * ldx + c];
    acc = w ? fmaf(v, w[r], acc) : acc + v;
  }
  out[(long long)s * ldo + c] = acc;
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

// per-block partial sums of (sigma_r * r + eps)^2 over a fixed grid
__global__ void loss_partial_kernel(const float* __restrict__ r,
                                    const float* __restrict__ eps,
                                    const float* __restrict__ sigma,
                                    long long total, int d,
                                    float* __restrict__ partial) {
  float acc = 0.f;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const float q = sigma[i / d] * r[i] + eps[i];
    acc = fmaf(q, q, acc);
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = acc;
}

__global__ void loss_final_kernel(const float* __restrict__ partial, int count,
                                  float inv_total, float* __restrict__ loss) {
  float acc = 0.f;
  for (int i = threadIdx.x; i < count; i += blockDim.x) acc += partial[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) loss[0] = acc * inv_total;
}

// dr = g * 2 * sigma * (sigma * r + eps) / (n * d)
__global__ void dloss_dr_kernel(const float* __restrict__ r,
                                const float* __restrict__ eps,
                                const float* __restrict__ sigma,
                                const float* __restrict__ g, long long total,
                                int d, float inv_total, float* __restrict__ dr) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const float s = sigma[i / d];
  dr[i] = g[0] * 2.f * s * (s * r[i] + eps[i]) * inv_total;
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
template <bool A_KC, bool B_KC, int EPI>
void sgemm(int M, int N, int K, int splits, const float* A, int lda,
           const float* B, int ldb, float* C, int ldc, const EpiParams& ep,
           cudaStream_t stream) {
  const int kps = split_len(K, splits);
  dim3 grid(cdiv(N, BN), cdiv(M, BM), cdiv(K, kps) > 0 ? cdiv(K, kps) : 1);
  sgemm_kernel<A_KC, B_KC, EPI><<<grid, NT, 0, stream>>>(
      M, N, K, kps, A, lda, vec_ok(A, lda), B, ldb, vec_ok(B, ldb), C, ldc,
      (long long)M * N, ep);
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

int colsum_seg(int n) { return cdiv(n, n < COLSUM_SEGS ? n : COLSUM_SEGS); }

void seg_colsum(const float* X, int n, int cols, int ldx, int seg,
                const float* w, float* out, int ldo, cudaStream_t stream) {
  dim3 grid(cdiv(cols, COLSUM_THREADS), cdiv(n, seg));
  seg_colsum_kernel<<<grid, COLSUM_THREADS, 0, stream>>>(X, n, cols, ldx, seg,
                                                          w, out, ldo);
}

void reduce_splits(const float* P, int S, int M, int N, float* out, int ldo_m,
                   int ldo_n, cudaStream_t stream) {
  const long long MN = (long long)M * N;
  reduce_splits_kernel<<<cdiv(MN, 256), 256, 0, stream>>>(P, S, M, N, out,
                                                          ldo_m, ldo_n);
}

}  // namespace

extern "C" {

// Scratch floats that fused_dsm_bwd needs (also covers fused_dsm_fwd's
// LOSS_BLOCKS loss partials).
long long fused_dsm_scratch_floats(int n, int n_layers, const int* in_dims,
                                   const int* out_dims) {
  long long need = LOSS_BLOCKS;
  for (int i = 0; i < n_layers; ++i) {
    const long long S = wgrad_splits(out_dims[i], in_dims[i], n);
    const long long w = S * out_dims[i] * in_dims[i];
    const long long b = (long long)cdiv(n, colsum_seg(n)) * out_dims[i];
    if (w > need) need = w;
    if (b > need) need = b;
  }
  return need;
}

// Forward. W[i] is (out_dims[i], ldw[i]) row-major, B[i] is (out_dims[i],).
// Layer l0 reads sigma's weight from column in_dims[l0] of W[l0] and adds
// ctx_l0[row / ssz]. acts: (n_layers - 1) blocks of n x act_ld floats, the
// post-activation of every layer but the last; r: (n, d); loss: 1 float.
int fused_dsm_fwd(int n, int d, int ssz, int n_layers, int l0, int act,
                  const float* xbar, const float* eps, const float* sigma,
                  const float* ctx_l0, int ctx_ld, const float* const* W,
                  const float* const* B, const int* in_dims,
                  const int* out_dims, const int* ldw, float* acts, int act_ld,
                  float* r, float* scratch, float* loss, cudaStream_t stream) {
  const float* hin = xbar;
  int hin_ld = d;
  for (int i = 0; i < n_layers; ++i) {
    const bool last = i == n_layers - 1;
    EpiParams ep = {};
    ep.bias = B[i];
    ep.act = last ? -1 : act;
    if (i == l0) {
      ep.sigma = sigma;
      ep.wsig = W[i] + in_dims[i];
      ep.wsig_ld = ldw[i];
      ep.ctx = ctx_l0;
      ep.ctx_ld = ctx_ld;
      ep.ssz = ssz;
    }
    float* out = last ? r : acts + (long long)i * n * act_ld;
    const int out_ld = last ? d : act_ld;
    sgemm<true, true, EPI_FWD>(n, out_dims[i], in_dims[i], 1, hin, hin_ld,
                               W[i], ldw[i], out, out_ld, ep, stream);
    hin = out;
    hin_ld = out_ld;
  }
  loss_partial_kernel<<<LOSS_BLOCKS, 256, 0, stream>>>(
      r, eps, sigma, (long long)n * d, d, scratch);
  loss_final_kernel<<<1, 256, 0, stream>>>(scratch, LOSS_BLOCKS,
                                           1.f / ((float)n * (float)d), loss);
  return (int)cudaGetLastError();
}

// Backward. g: the upstream cotangent (1 float on the device). dW[i] and
// dB[i] are laid out like W[i] and B[i] (dW[l0] includes sigma's column);
// dctx: (n / ssz, ctx_ld). dp0, dp1: n x max(out_dims) floats each.
int fused_dsm_bwd(int n, int d, int ssz, int n_layers, int l0, int act,
                  const float* xbar, const float* eps, const float* sigma,
                  const float* g, const float* const* W, const int* in_dims,
                  const int* out_dims, const int* ldw, const float* acts,
                  int act_ld, const float* r, float* const* dW,
                  float* const* dB, float* dctx, int ctx_ld, float* dp0,
                  float* dp1, float* scratch, cudaStream_t stream) {
  const long long total = (long long)n * d;
  float* dp = dp0;
  float* dp_next = dp1;
  dloss_dr_kernel<<<cdiv(total, 256), 256, 0, stream>>>(
      r, eps, sigma, g, total, d, 1.f / ((float)n * (float)d), dp);
  const int seg = colsum_seg(n);
  const int nseg = cdiv(n, seg);
  for (int i = n_layers - 1; i >= 0; --i) {
    const int out = out_dims[i], in = in_dims[i];
    const float* hin = i == 0 ? xbar : acts + (long long)(i - 1) * n * act_ld;
    const int hin_ld = i == 0 ? d : act_ld;
    // dW[:, :in] = dp^T @ hin, split over rows, then a fixed-order sum
    const int S = wgrad_splits(out, in, n);
    EpiParams none = {};
    none.act = -1;
    sgemm<false, false, EPI_STORE>(out, in, n, S, dp, out, hin, hin_ld,
                                   scratch, in, none, stream);
    reduce_splits(scratch, S, out, in, dW[i], ldw[i], 1, stream);
    // db = column sums of dp
    seg_colsum(dp, n, out, out, seg, nullptr, scratch, out, stream);
    reduce_splits(scratch, nseg, 1, out, dB[i], 0, 1, stream);
    if (i == l0) {
      // sigma's weight column: sum_r sigma_r * dp[r, :]
      seg_colsum(dp, n, out, out, seg, sigma, scratch, out, stream);
      reduce_splits(scratch, nseg, 1, out, dW[i] + in, 0, ldw[i], stream);
      // d/d ctx_l0: one segment per item
      seg_colsum(dp, n, out, out, ssz, nullptr, dctx, ctx_ld, stream);
    }
    if (i > 0) {
      // dp_next = (dp @ W[:, :in]) * phi'(hin)
      EpiParams ep = {};
      ep.hin = hin;
      ep.hin_ld = hin_ld;
      ep.act = act;
      sgemm<true, false, EPI_DH>(n, in, out, 1, dp, out, W[i], ldw[i],
                                 dp_next, in, ep, stream);
      float* t = dp;
      dp = dp_next;
      dp_next = t;
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
