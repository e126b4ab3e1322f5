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
//  * The tiled SGEMM of dsm_sgemm.cuh (128x128x8 block tile, float4 shared
//    reads, register double buffer, ragged edges masked) with three
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

#include "dsm_sgemm.cuh"

namespace {

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
    float* out = last ? r : acts + (long long)i * n * act_ld;
    const int out_ld = last ? d : act_ld;
    FwdEpi ep = {};
    ep.C = out;
    ep.ldc = out_ld;
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
    sgemm<true, true>(n, out_dims[i], in_dims[i], 1, hin, hin_ld, W[i], ldw[i],
                      ep, stream);
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
  for (int i = n_layers - 1; i >= 0; --i) {
    const int out = out_dims[i], in = in_dims[i];
    const float* hin = i == 0 ? xbar : acts + (long long)(i - 1) * n * act_ld;
    const int hin_ld = i == 0 ? d : act_ld;
    // dW[:, :in] = dp^T @ hin, split over rows, then a fixed-order sum
    const int S = wgrad_splits(out, in, n);
    wgrad_partials(out, in, n, S, dp, out, hin, hin_ld, scratch, stream);
    reduce_splits(scratch, S, out, in, dW[i], ldw[i], 1, stream);
    // db = column sums of dp
    colsum(dp, n, out, out, nullptr, scratch, dB[i], 1, stream);
    if (i == l0) {
      // sigma's weight column: sum_r sigma_r * dp[r, :]
      colsum(dp, n, out, out, sigma, scratch, dW[i] + in, ldw[i], stream);
      // d/d ctx_l0: one segment per item
      seg_colsum(dp, n, out, out, ssz, nullptr, dctx, ctx_ld, stream);
    }
    if (i > 0) {
      // dp_next = (dp @ W[:, :in]) * phi'(hin)
      const DhEpi ep = {dp_next, in, hin, hin_ld, act};
      sgemm<true, false>(n, in, out, 1, dp, out, W[i], ldw[i], ep, stream);
      float* t = dp;
      dp = dp_next;
      dp_next = t;
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
