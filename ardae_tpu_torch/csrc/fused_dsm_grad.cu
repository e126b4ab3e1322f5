// Fused second-order denoising-score-matching loss of the GRADIENT-style
// conditional AR-DAE (score = -d e / d xbar of a scalar energy MLP), loss
// and every parameter gradient, fp32, for NVIDIA Hopper (sm_90a).
//
// Replaces both Pallas TPU layouts of this one function:
//   ardae_tpu/ops/fused_dsm_grad.py:114  _kernel (row tiles, (n, h) ctx rows)
//   ardae_tpu/ops/fused_dsm_grad2.py:90  _kernel (item-aligned grid, (bsz, h)
//                                                 ctx, unnormalised tangent)
// by fused_dsm_grad_fwd (steps 1-3) and fused_dsm_grad_bwd (steps 4-5).
//
// Layers k = 0 .. L-2 are the hidden layers (E encoder layers, the split
// first trunk layer l0 = E, H trunk layers), each with pre-activation z_k and
// post-activation u_k+1 = phi(z_k); u_0 = xbar (n, d). Layer L-1 is the
// energy head w_out (h -> 1). For n = bsz * ssz rows (item = row / ssz):
//   1. forward      z_k = u_k @ W_k^T + b_k (+ sigma * w_sig + ctx_l0[item]
//                   at l0); the energy e = u_L-1 . w_out + b_out is not needed
//   2. input grad   d_L-2 = w_out * phi'(z_L-2);
//                   d_k-1 = (d_k @ W_k[:, :in]) * phi'(z_k-1);  g = d_0 @ W_0
//   3. loss         R = sigma * s + eps = eps - sigma * g;  L = sum(R^2) / N,
//                   N = n * d
//   4. tangent      along w = -2 * gout * sigma * R / N (gout: the upstream
//                   cotangent): tu_0 = w, tz_k = tu_k @ W_k[:, :in]^T,
//                   tu_k+1 = phi'(z_k) * tz_k
//   5. reverse over both chains (the JVP identity dL/dtheta = d/dtheta
//      sum_rows JVP(e; w) with w held constant, ops/fused_dsm_grad.py:22-27):
//      the tangent chain's adjoint is d_k (step 2's chain, reused); the primal
//      adjoint Ap_k = A_k * phi'(z_k) + c_k with c_k = d_k * (phi''/phi')(z_k)
//      * tz_k, A_L-2 = 0 and A_k-1 = Ap_k @ W_k[:, :in];
//        dW_k[:, :in] = Ap_k^T u_k + d_k^T tu_k,  db_k = sum_rows Ap_k,
//        dw_sig = sum_rows sigma * Ap_l0,  d ctx_l0[item] = sum_item Ap_l0,
//        d w_out = sum_rows tu_L-1,  d b_out = 0.
// phi, phi' and phi''/phi' come from the stored post-activation u (softplus:
// sigmoid = 1 - exp(-u), 1 - sigmoid = exp(-u); relu: u > 0, 0; tanh: 1 - u^2,
// -2u), so no pre-activation is stored.
//
// Design on this card (what bounds it, and what the design does about it):
//  * fp32 on the CUDA cores, bound by the ~67 TFLOP/s fp32 FMA rate. At the
//    implicit-conv line (n = 80,000, d = 32, h = 256, E = 5, H = 4) a pass
//    over the layers is ~0.6 M MACs a row, 96 GFLOP; the forward makes two
//    passes (1, 2), the backward four (tangent, two weight-gradient products,
//    primal adjoint): ~0.58 TFLOP an update. The TPU kernels recomputed
//    step 2's chain in step 5; here the forward keeps it (d_k), which saves
//    one pass.
//  * No block can hold a row tile's whole chain (a (128, 256) fp32 tile is
//    128 KB of 227 KB), so each layer of each chain is one launch of the
//    shared SGEMM, with the chain's elementwise work fused in its epilogue;
//    weights stream from L2.
//  * Workspace: u_k and d_k from the forward, tu_k and c_k in the backward,
//    4 x (L-1) x n x h fp32 (3.3 GB at the line), read back by the later
//    products. The top layer's adjoint seeds (w_out broadcast) never become
//    a 128-wide GEMM: d_L-2 and d w_out are elementwise and column sums.
//  * Deterministic: no atomics. dW is two split-K products whose partials a
//    fixed-order pass sums; db, sigma's column, d w_out and d/d(ctx_l0) are
//    column sums over fixed row segments (one per item for ctx_l0); the loss
//    is a fixed-grid block sum. Every edge is masked; no row is padded.
//
// Plain C interface, loaded with ctypes; every entry point launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include "dsm_sgemm.cuh"

namespace {

// R = eps - sigma * g, g = acc = d e / d xbar
struct ResidEpi {
  float* R;
  const float* sigma;
  const float* eps;
  int d;
  __device__ __forceinline__ void operator()(int m, int n, float v) const {
    const long long i = (long long)m * d + n;
    R[i] = fmaf(-sigma[m], v, eps[i]);
  }
};

// tz = acc: tu = phi'(z) * tz (the next layer's tangent input) and
// c = d * (phi''/phi')(z) * tz (the curvature term of the primal adjoint)
struct TangentEpi {
  float* tu;
  float* c;
  const float* u;
  const float* delta;
  int ld;
  int act;
  __device__ __forceinline__ void operator()(int m, int n, float v) const {
    const long long i = (long long)m * ld + n;
    const float uu = u[i];
    tu[i] = act_grad_from_out(act, uu) * v;
    c[i] = delta[i] * act_curv_from_out(act, uu) * v;
  }
};

// Ap = acc * phi'(z) + c, acc = Ap_next @ W[:, :in]
struct RevEpi {
  float* ap;
  const float* u;
  const float* c;
  int ld;
  int act;
  __device__ __forceinline__ void operator()(int m, int n, float v) const {
    const long long i = (long long)m * ld + n;
    ap[i] = fmaf(v, act_grad_from_out(act, u[i]), c[i]);
  }
};

// d[r, c] = w_out[c] * phi'(z) for the top hidden layer, from u
__global__ void top_delta_kernel(const float* __restrict__ u,
                                 const float* __restrict__ w_out, long long total,
                                 int h, int act, float* __restrict__ delta) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  delta[i] = w_out[i % h] * act_grad_from_out(act, u[i]);
}

// per-block partial sums of R^2 over a fixed grid
__global__ void sumsq_partial_kernel(const float* __restrict__ x,
                                     long long total,
                                     float* __restrict__ partial) {
  float acc = 0.f;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x)
    acc = fmaf(x[i], x[i], acc);
  acc = block_sum(acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = acc;
}

// w = -2 * gout * sigma * R / N
__global__ void tangent_seed_kernel(const float* __restrict__ R,
                                    const float* __restrict__ sigma,
                                    const float* __restrict__ g, long long total,
                                    int d, float inv_total,
                                    float* __restrict__ w) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  w[i] = -2.f * g[0] * sigma[i / d] * R[i] * inv_total;
}

}  // namespace

extern "C" {

// Scratch floats that fused_dsm_grad_bwd needs (also covers the forward's
// LOSS_BLOCKS loss partials): two split-K partial sets per weight gradient,
// or the segment partials of a column sum.
long long fused_dsm_grad_scratch_floats(int n, int n_layers,
                                        const int* in_dims,
                                        const int* out_dims) {
  long long need = LOSS_BLOCKS;
  for (int k = 0; k < n_layers; ++k) {
    const long long S = wgrad_splits(out_dims[k], in_dims[k], n);
    const long long w = 2 * S * out_dims[k] * in_dims[k];
    const long long b = (long long)cdiv(n, colsum_seg(n)) * in_dims[k];
    const long long b2 = (long long)cdiv(n, colsum_seg(n)) * out_dims[k];
    if (w > need) need = w;
    if (b > need) need = b;
    if (b2 > need) need = b2;
  }
  return need;
}

// Forward, steps 1-3. W[k] is (out_dims[k], ldw[k]) row-major, B[k] is
// (out_dims[k],); the hidden layers are h wide (out_dims[k] == h, k < L-1)
// and W[L-1] is w_out (1, h). Layer l0 reads sigma's weight from column
// in_dims[l0] of W[l0] and adds ctx_l0[row / ssz]. acts, deltas: (L-1)
// blocks of n x h floats (u_k+1 and d_k); R: (n, d); loss: 1 float.
int fused_dsm_grad_fwd(int n, int d, int ssz, int n_layers, int l0, int act,
                       const float* xbar, const float* eps, const float* sigma,
                       const float* ctx_l0, int ctx_ld, const float* const* W,
                       const float* const* B, const int* in_dims,
                       const int* out_dims, const int* ldw, float* acts,
                       float* deltas, int h, float* R, float* scratch,
                       float* loss, cudaStream_t stream) {
  const int top = n_layers - 2;
  const long long nh = (long long)n * h;
  // 1. forward chain: acts[k] = phi(z_k)
  const float* hin = xbar;
  int hin_ld = d;
  for (int k = 0; k <= top; ++k) {
    FwdEpi ep = {};
    ep.C = acts + k * nh;
    ep.ldc = h;
    ep.bias = B[k];
    ep.act = act;
    if (k == l0) {
      ep.sigma = sigma;
      ep.wsig = W[k] + in_dims[k];
      ep.wsig_ld = ldw[k];
      ep.ctx = ctx_l0;
      ep.ctx_ld = ctx_ld;
      ep.ssz = ssz;
    }
    sgemm<true, true>(n, out_dims[k], in_dims[k], 1, hin, hin_ld, W[k], ldw[k],
                      ep, stream);
    hin = acts + k * nh;
    hin_ld = h;
  }
  // 2. input-gradient chain d_k, seeded by w_out without a GEMM
  top_delta_kernel<<<cdiv(nh, 256), 256, 0, stream>>>(
      acts + top * nh, W[n_layers - 1], nh, h, act, deltas + top * nh);
  for (int k = top; k >= 1; --k) {
    const DhEpi ep = {deltas + (k - 1) * nh, h, acts + (k - 1) * nh, h, act};
    sgemm<true, false>(n, in_dims[k], out_dims[k], 1, deltas + k * nh, h, W[k],
                       ldw[k], ep, stream);
  }
  // 3. g = d_0 @ W_0, R = eps - sigma * g, loss = sum(R^2) / N
  const ResidEpi ep = {R, sigma, eps, d};
  sgemm<true, false>(n, d, out_dims[0], 1, deltas, h, W[0], ldw[0], ep, stream);
  sumsq_partial_kernel<<<LOSS_BLOCKS, 256, 0, stream>>>(R, (long long)n * d,
                                                        scratch);
  loss_final_kernel<<<1, 256, 0, stream>>>(scratch, LOSS_BLOCKS,
                                           1.f / ((float)n * (float)d), loss);
  return (int)cudaGetLastError();
}

// Backward, steps 4-5, every gradient scaled by the upstream cotangent g
// (1 float on the device). dW[k] and dB[k] are laid out like W[k] and B[k]
// (dW[l0] includes sigma's column; dB[L-1] is set to 0); dctx:
// (n / ssz, ctx_ld). tan0: (n, d); tans, curvs: (L-1) blocks of n x h (tu_k+1
// and c_k); ap0, ap1: n x h each.
int fused_dsm_grad_bwd(int n, int d, int ssz, int n_layers, int l0, int act,
                       const float* xbar, const float* sigma, const float* R,
                       const float* g, const float* const* W,
                       const int* in_dims, const int* out_dims, const int* ldw,
                       const float* acts, const float* deltas, int h,
                       float* const* dW, float* const* dB, float* dctx,
                       int ctx_ld, float* tan0, float* tans, float* curvs,
                       float* ap0, float* ap1, float* scratch,
                       cudaStream_t stream) {
  const int top = n_layers - 2;
  const long long nh = (long long)n * h;
  const long long total = (long long)n * d;
  // 4. tangent chain along w
  tangent_seed_kernel<<<cdiv(total, 256), 256, 0, stream>>>(
      R, sigma, g, total, d, 1.f / ((float)n * (float)d), tan0);
  const float* tin = tan0;
  int tin_ld = d;
  for (int k = 0; k <= top; ++k) {
    const TangentEpi ep = {tans + k * nh, curvs + k * nh, acts + k * nh,
                           deltas + k * nh, h, act};
    sgemm<true, true>(n, out_dims[k], in_dims[k], 1, tin, tin_ld, W[k], ldw[k],
                      ep, stream);
    tin = tans + k * nh;
    tin_ld = h;
  }
  // the energy head: d w_out = sum_rows tu_L-1; b_out does not reach the score
  colsum(tans + top * nh, n, h, h, nullptr, scratch, dW[n_layers - 1], 1, stream);
  cudaMemsetAsync(dB[n_layers - 1], 0, sizeof(float), stream);
  // 5. reverse over the primal (Ap) and tangent (d) chains
  const float* ap = curvs + top * nh;   // A_L-2 = 0: Ap_L-2 = c_L-2
  float* bufs[2] = {ap0, ap1};
  for (int k = top; k >= 0; --k) {
    const int out = out_dims[k], in = in_dims[k];
    const float* u_in = k == 0 ? xbar : acts + (k - 1) * nh;
    const float* t_in = k == 0 ? tan0 : tans + (k - 1) * nh;
    const int in_ld = k == 0 ? d : h;
    // dW[:, :in] = Ap^T u + d^T tu: both products' split-K partials, one
    // fixed-order sum
    const int S = wgrad_splits(out, in, n);
    wgrad_partials(out, in, n, S, ap, h, u_in, in_ld, scratch, stream);
    wgrad_partials(out, in, n, S, deltas + k * nh, h, t_in, in_ld,
                   scratch + (long long)S * out * in, stream);
    reduce_splits(scratch, 2 * S, out, in, dW[k], ldw[k], 1, stream);
    colsum(ap, n, out, h, nullptr, scratch, dB[k], 1, stream);
    if (k == l0) {
      colsum(ap, n, out, h, sigma, scratch, dW[k] + in, ldw[k], stream);
      seg_colsum(ap, n, out, h, ssz, nullptr, dctx, ctx_ld, stream);
    }
    if (k > 0) {
      float* next = bufs[k & 1];
      const RevEpi ep = {next, acts + (k - 1) * nh, curvs + (k - 1) * nh, h,
                         act};
      sgemm<true, false>(n, in, out, 1, ap, h, W[k], ldw[k], ep, stream);
      ap = next;
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
