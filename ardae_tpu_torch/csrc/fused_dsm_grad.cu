// Fused second-order denoising-score-matching loss of the GRADIENT-style
// conditional AR-DAE (score = -d e / d xbar of a scalar energy MLP), loss
// and every parameter gradient, for NVIDIA Hopper (sm_90a), in either of the
// TPU kernels' compute modes (the entry points' prec argument):
//   PREC_F32   every product fp32-accurate (3xTF32);
//   PREC_BF16  rounded to bf16 where the TPU row-tile kernel's
//              compute_dtype="bfloat16" (its default) rounds: each
//              product's operands (the weight matrices, w_out and sigma's
//              weight, the activations, the tangent direction w, the
//              tangent and adjoint chains), the stored pre-activations and
//              tangent products that phi, phi' and phi'' are taken from,
//              and the primal adjoints that db, sigma's column and
//              d ctx_l0 sum; fp32 accumulation; biases, sigma, eps, the ctx
//              rows, the loss and every gradient sum stay fp32 (the bf16
//              epilogues below say where each rounding sits).
//
// Replaces both Pallas TPU layouts of this one function, in both modes:
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
// -2u), so no pre-activation is stored (the bf16 mode keeps bf16(z_k) only
// until step 2, below).
//
// Design on this card (what bounds it, and what the design does about it):
//  * The products bound it. At the implicit-conv line (n = 80,000, d = 32,
//    h = 256, E = 5, H = 4) a pass over the layers is ~0.6 M MACs a row,
//    96 GFLOP; the forward makes two passes (1, 2), the backward four
//    (tangent, two weight-gradient products, primal adjoint): 0.192 +
//    0.384 TFLOP an update. On the CUDA cores (67 TFLOP/s fp32) that is
//    2.87 + 5.73 ms at best; on the tensor cores, fp32-accurate as 3xTF32
//    (495 TFLOP/s TF32 at 700 W, three products each), 1.16 + 2.33 ms. The
//    second-order tangents need fp32's accuracy (they are ~1e-9 early in
//    training), which 3xTF32 keeps and plain TF32 or bf16 would not. The
//    TPU kernels recomputed step 2's chain in step 5; here the forward
//    keeps it (d_k), which saves one pass.
//  * The bf16 mode does the same 0.192 + 0.384 TFLOP an update at 989
//    TFLOP/s bf16: about 0.19 + 0.39 ms as its operations bound. It takes
//    one m64n128k16 bf16 wgmma a k-step instead of 3xTF32's three m64n128k8
//    ones (each operand rounded once, to nearest even: the weight by prep_b,
//    A in the consumers' registers, the weight gradients' B in the core's
//    stagers). Everything else is the fp32 mode's: the fp32 workspace and
//    its traffic (below), the ring, the reductions, and epilogues that add
//    only the roundings and a write of bf16(z) and of the tangent input
//    below l0. So the bf16 mode is bound by that traffic: its A tiles are
//    fp32 (16 KB a k-tile for 4 wgmma), and the core measured ~90
//    TFLOP/s at h 256 (scripts/torch_dsm_measure.py core) for 4.4 +
//    6.9 ms an update (chip_smoke.py phase 13a). Storing the workspace in
//    bf16 is what would move it toward its bound.
//  * No block can hold a row tile's whole chain (a (128, 256) fp32 tile is
//    128 KB of 227 KB), so each layer of each chain is one launch of the
//    shared GEMM core of dsm_sgemm.cuh (wgmma with TMA, persistent and
//    warp-specialised: each operand split once into tf32 hi and lo, the
//    weight by prep_b once a product, A in the consumers' registers, the
//    weight gradients' activations by the core's stagers), with the chain's
//    elementwise work fused in its epilogue, fed row by row from shared
//    memory with its loads batched; weights stream from L2. The products
//    with W_k[:, :in] (steps 2, 3 and the primal adjoint) read its
//    transpose laid out K-major by prep_b, and l0's weight (stride in + 1)
//    goes through prep_b like every other. Measured on an H100 80GB HBM3 at
//    700 W: ~61 TFLOP/s of fp32 products in the h x h products
//    and ~69 in the weight gradients (scripts/torch_dsm_measure.py core),
//    against a 3xTF32 ceiling of ~163 (wgmma TF32 488 TFLOP/s,
//    scripts/torch_mma_peak.py); 4.9 + 8.3 ms an update at the line
//    (chip_smoke.py phase 4b). At h 256 a unit has 8 k-tiles, so its
//    epilogue, which runs between units and not under them, weighs more
//    than at the flagship's 16.
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
// given stream, allocates nothing, and returns the launches' status
// (launch_status: the first GEMM the core refused, else cudaGetLastError()).

#include <type_traits>

#include "dsm_sgemm.cuh"

namespace {

// R = eps - sigma * g, g = acc = d e / d xbar
struct ResidEpi {
  float* R;
  const float* sigma;
  const float* eps;
  int d;
  struct In { float sigma, eps; };
  __device__ __forceinline__ In load(int m, int n) const {
    return {sigma[m], eps[(long long)m * d + n]};
  }
  __device__ __forceinline__ void store(int m, int n, float v, In in) const {
    R[(long long)m * d + n] = fmaf(-in.sigma, v, in.eps);
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
  struct In { float u, delta; };
  __device__ __forceinline__ In load(int m, int n) const {
    const long long i = (long long)m * ld + n;
    return {u[i], delta[i]};
  }
  __device__ __forceinline__ void store(int m, int n, float v, In in) const {
    const long long i = (long long)m * ld + n;
    tu[i] = act_grad_from_out(act, in.u) * v;
    c[i] = in.delta * act_curv_from_out(act, in.u) * v;
  }
};

// Ap = acc * phi'(z) + c, acc = Ap_next @ W[:, :in]
struct RevEpi {
  float* ap;
  const float* u;
  const float* c;
  int ld;
  int act;
  struct In { float u, c; };
  __device__ __forceinline__ In load(int m, int n) const {
    const long long i = (long long)m * ld + n;
    return {u[i], c[i]};
  }
  __device__ __forceinline__ void store(int m, int n, float v, In in) const {
    ap[(long long)m * ld + n] = fmaf(v, act_grad_from_out(act, in.u), in.c);
  }
};

// ---- the bf16 mode's epilogues and kernels ----
// They round where the TPU row-tile kernel rounds in its bf16 mode
// (ardae_tpu/ops/fused_dsm_grad.py:135-256): the pre-activations z and
// the tangent products tz are stored in bf16, and phi, phi' and phi'' are
// taken from those stored values; the weight matrices (w_out and sigma's
// weight too), the forward and tangent inputs of each product and the
// primal adjoints Ap (summed into db, sigma's column and d ctx_l0 as
// rounded) are rounded; z, tz and every product accumulate in fp32. The
// forward's next-layer input is phi of the unrounded z, and below l0 the
// next tangent input is phi'(z) of the unrounded tz, while the reverse
// takes both from the stored values: two values each, so the forward
// keeps bf16(z) in the d_k buffer until step 2 replaces it, and the
// tangent chain below l0 passes its input through ap0 / ap1. (The
// item-aligned TPU kernel, fused_dsm_grad2.py:90, rounds a few values
// otherwise in its bf16 mode; among them, it keeps sigma's weight in
// fp32, takes l0's tangent factors from the unrounded z and tz, takes the
// next tangent input from the unrounded tz above l0 too, and scales its
// tangent by N.)

// x rounded to the nearest bf16 (ties to even), back in fp32
__device__ __forceinline__ float bf16_round(float x) {
  unsigned short b;
  asm("cvt.rn.bf16.f32 %0, %1;\n" : "=h"(b) : "f"(x));
  return __uint_as_float((uint32_t)b << 16);
}

// phi'(z) from the pre-activation z
__device__ __forceinline__ float act_grad_from_pre(int act, float z) {
  if (act == ACT_SOFTPLUS) return 1.f / (1.f + expf(-z));
  if (act == ACT_RELU) return z > 0.f ? 1.f : 0.f;
  const float t = tanhf(z);
  return 1.f - t * t;
}

// forward: z = acc + sigma * bf16(w_sig) + bias + ctx[m / ssz] (the TPU
// kernel's order); u = phi(z) (the next layer's input), zb = bf16(z)
struct FwdEpiBF16 {
  float* u;
  float* zb;
  int ld;
  const float* bias;
  const float* sigma;     // as FwdEpi's: null except on the split layer
  const float* wsig;
  int wsig_ld;
  const float* ctx;
  int ctx_ld, ssz;
  int act;
  struct In { float b, sw, cx; };
  __device__ __forceinline__ In load(int m, int n) const {
    In in = {bias[n], 0.f, 0.f};
    if (wsig) in.sw = sigma[m] * bf16_round(wsig[(long long)n * wsig_ld]);
    if (ctx) in.cx = ctx[(long long)(m / ssz) * ctx_ld + n];
    return in;
  }
  __device__ __forceinline__ void store(int m, int n, float v, In in) const {
    if (wsig) v += in.sw;
    v += in.b;
    if (ctx) v += in.cx;
    const long long i = (long long)m * ld + n;
    u[i] = act_fwd(act, v);
    zb[i] = bf16_round(v);
  }
};

// input gradient: d = acc * phi'(zb), zb read from d's own place; and the
// reverse's u = phi(zb) in place of the forward's
struct DhEpiBF16 {
  float* delta;
  float* u;
  int ld;
  int act;
  struct In { float zb; };
  __device__ __forceinline__ In load(int m, int n) const {
    return {delta[(long long)m * ld + n]};
  }
  __device__ __forceinline__ void store(int m, int n, float v, In in) const {
    const long long i = (long long)m * ld + n;
    delta[i] = v * act_grad_from_pre(act, in.zb);
    u[i] = act_fwd(act, in.zb);
  }
};

// d = bf16(w_out[c]) * phi'(zb) and u = phi(zb) for the top hidden layer
__global__ void top_delta_bf16_kernel(float* __restrict__ u,
                                      const float* __restrict__ w_out,
                                      long long total, int h, int act,
                                      float* __restrict__ delta) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const float zb = delta[i];
  delta[i] = bf16_round(w_out[i % h]) * act_grad_from_pre(act, zb);
  u[i] = act_fwd(act, zb);
}

// tangent: tzb = bf16(tz = acc); tu = bf16(phi'(zb) * tzb), the reverse's
// tangent input (and the next layer's from l0 on); below l0, tnext =
// phi'(zb) * tz, the next layer's; c = d * (phi''/phi')(zb) * tzb, rounded
// on the top layer, where it is the primal adjoint Ap itself
struct TangentEpiBF16 {
  float* tu;
  float* tnext;
  float* c;
  const float* u;
  const float* delta;
  int ld;
  int act;
  bool round_c;
  struct In { float u, delta; };
  __device__ __forceinline__ In load(int m, int n) const {
    const long long i = (long long)m * ld + n;
    return {u[i], delta[i]};
  }
  __device__ __forceinline__ void store(int m, int n, float v, In in) const {
    const long long i = (long long)m * ld + n;
    const float f = act_grad_from_out(act, in.u), tzb = bf16_round(v);
    tu[i] = bf16_round(f * tzb);
    if (tnext) tnext[i] = f * v;
    const float cc = in.delta * act_curv_from_out(act, in.u) * tzb;
    c[i] = round_c ? bf16_round(cc) : cc;
  }
};

// reverse: Ap = bf16(acc * phi'(zb) + c)
struct RevEpiBF16 {
  float* ap;
  const float* u;
  const float* c;
  int ld;
  int act;
  struct In { float u, c; };
  __device__ __forceinline__ In load(int m, int n) const {
    const long long i = (long long)m * ld + n;
    return {u[i], c[i]};
  }
  __device__ __forceinline__ void store(int m, int n, float v, In in) const {
    ap[(long long)m * ld + n] =
        bf16_round(v * act_grad_from_out(act, in.u) + in.c);
  }
};

// x[i] *= g[0]
__global__ void scale_kernel(float* __restrict__ x, long long total,
                             const float* __restrict__ g) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < total) x[i] *= g[0];
}

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

// w = -2 * gout * sigma * R / N; gout = 1 where g is null
__global__ void tangent_seed_kernel(const float* __restrict__ R,
                                    const float* __restrict__ sigma,
                                    const float* __restrict__ g, long long total,
                                    int d, float inv_total,
                                    float* __restrict__ w) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  w[i] = -2.f * (g ? g[0] : 1.f) * sigma[i / d] * R[i] * inv_total;
}

// Forward, steps 1-3, and backward, steps 4-5, with their products in PREC;
// the arguments are the entry points' below.
template <int PREC>
int grad_fwd(int n, int d, int ssz, int n_layers, int l0, int act,
             const float* xbar, const float* eps, const float* sigma,
             const float* ctx_l0, int ctx_ld, const float* const* W,
             const float* const* B, const int* in_dims, const int* out_dims,
             const int* ldw, float* acts, float* deltas, int h, float* R,
             float* scratch, float* loss, cudaStream_t stream);

template <int PREC>
int grad_bwd(int n, int d, int ssz, int n_layers, int l0, int act,
             const float* xbar, const float* sigma, const float* R,
             const float* g, const float* const* W, const int* in_dims,
             const int* out_dims, const int* ldw, const float* acts,
             const float* deltas, int h, float* const* dW, float* const* dB,
             float* dctx, int ctx_ld, float* tan0, float* tans, float* curvs,
             float* ap0, float* ap1, float* scratch, cudaStream_t stream);

}  // namespace

extern "C" {

// Scratch floats that fused_dsm_grad_bwd needs (also covers the forward's
// LOSS_BLOCKS loss partials): two split-K partial sets per weight gradient,
// or the segment partials of a column sum.
long long fused_dsm_grad_scratch_floats(int n, int n_layers,
                                        const int* in_dims,
                                        const int* out_dims) {
  long long need = LOSS_BLOCKS;   // after the laid-out weight (prep_b)
  for (int k = 0; k < n_layers; ++k) {
    const long long S = wgrad_splits(out_dims[k], in_dims[k], n);
    const long long w = 2 * S * out_dims[k] * in_dims[k];
    const long long b = (long long)cdiv(n, colsum_seg(n)) * in_dims[k];
    const long long b2 = (long long)cdiv(n, colsum_seg(n)) * out_dims[k];
    if (w > need) need = w;
    if (b > need) need = b;
    if (b2 > need) need = b2;
  }
  return prep_floats(n_layers, in_dims, out_dims) + need;
}

// Forward, steps 1-3, its products in prec (PREC_F32 0, PREC_BF16 1; any
// other value returns cudaErrorInvalidValue and launches nothing). W[k] is
// (out_dims[k], ldw[k]) row-major, B[k] is (out_dims[k],); the hidden
// layers are h wide (out_dims[k] == h, k < L-1) and W[L-1] is w_out (1,
// h). Layer l0 reads sigma's weight from column in_dims[l0] of W[l0] and
// adds ctx_l0[row / ssz]. acts, deltas: (L-1) blocks of n x h floats (u_k+1
// and d_k); R: (n, d); loss: 1 float.
int fused_dsm_grad_fwd(int n, int d, int ssz, int n_layers, int l0, int act,
                       int prec, const float* xbar, const float* eps,
                       const float* sigma, const float* ctx_l0, int ctx_ld,
                       const float* const* W, const float* const* B,
                       const int* in_dims, const int* out_dims, const int* ldw,
                       float* acts, float* deltas, int h, float* R,
                       float* scratch, float* loss, cudaStream_t stream) {
  auto run = prec == PREC_F32 ? grad_fwd<PREC_F32>
             : prec == PREC_BF16 ? grad_fwd<PREC_BF16> : nullptr;
  if (!run) return (int)cudaErrorInvalidValue;
  return run(n, d, ssz, n_layers, l0, act, xbar, eps, sigma, ctx_l0, ctx_ld,
             W, B, in_dims, out_dims, ldw, acts, deltas, h, R, scratch, loss,
             stream);
}

// Backward, steps 4-5, every gradient scaled by the upstream cotangent g
// (1 float on the device), its products in prec (as the forward's). dW[k]
// and dB[k] are laid out like W[k] and B[k] (dW[l0] includes sigma's
// column; dB[L-1] is set to 0); dctx: (n / ssz, ctx_ld). tan0: (n, d);
// tans, curvs: (L-1) blocks of n x h (tu_k+1 and c_k); ap0, ap1: n x h each.
int fused_dsm_grad_bwd(int n, int d, int ssz, int n_layers, int l0, int act,
                       int prec, const float* xbar, const float* sigma,
                       const float* R, const float* g, const float* const* W,
                       const int* in_dims, const int* out_dims, const int* ldw,
                       const float* acts, const float* deltas, int h,
                       float* const* dW, float* const* dB, float* dctx,
                       int ctx_ld, float* tan0, float* tans, float* curvs,
                       float* ap0, float* ap1, float* scratch,
                       cudaStream_t stream) {
  auto run = prec == PREC_F32 ? grad_bwd<PREC_F32>
             : prec == PREC_BF16 ? grad_bwd<PREC_BF16> : nullptr;
  if (!run) return (int)cudaErrorInvalidValue;
  return run(n, d, ssz, n_layers, l0, act, xbar, sigma, R, g, W, in_dims,
             out_dims, ldw, acts, deltas, h, dW, dB, dctx, ctx_ld, tan0, tans,
             curvs, ap0, ap1, scratch, stream);
}

}  // extern "C"

namespace {

template <int PREC>
int grad_fwd(int n, int d, int ssz, int n_layers, int l0, int act,
             const float* xbar, const float* eps, const float* sigma,
             const float* ctx_l0, int ctx_ld, const float* const* W,
             const float* const* B, const int* in_dims, const int* out_dims,
             const int* ldw, float* acts, float* deltas, int h, float* R,
             float* scratch, float* loss, cudaStream_t stream) {
  const int top = n_layers - 2;
  const long long nh = (long long)n * h;
  float* prep = scratch;   // each product's weight, converted (prep_b)
  scratch += prep_floats(n_layers, in_dims, out_dims);
  // 1. forward chain: acts[k] = phi(z_k)
  const float* hin = xbar;
  int hin_ld = d;
  for (int k = 0; k <= top; ++k) {
    std::conditional_t<PREC == PREC_BF16, FwdEpiBF16, FwdEpi> ep = {};
    if constexpr (PREC == PREC_BF16) {
      ep.u = acts + k * nh;
      ep.zb = deltas + k * nh;   // bf16(z_k) until step 2
      ep.ld = h;
    } else {
      ep.C = acts + k * nh;
      ep.ldc = h;
    }
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
    sgemm_w<PREC>(n, out_dims[k], in_dims[k], hin, hin_ld, W[k], ldw[k], false,
                  prep, ep, stream);
    hin = acts + k * nh;
    hin_ld = h;
  }
  // 2. input-gradient chain d_k, seeded by w_out without a GEMM (bf16: from
  // bf16(z_k), and u_k+1 becomes phi(bf16(z_k)) for the backward)
  if constexpr (PREC == PREC_BF16)
    top_delta_bf16_kernel<<<cdiv(nh, 256), 256, 0, stream>>>(
        acts + top * nh, W[n_layers - 1], nh, h, act, deltas + top * nh);
  else
    top_delta_kernel<<<cdiv(nh, 256), 256, 0, stream>>>(
        acts + top * nh, W[n_layers - 1], nh, h, act, deltas + top * nh);
  for (int k = top; k >= 1; --k) {
    if constexpr (PREC == PREC_BF16) {
      const DhEpiBF16 ep = {deltas + (k - 1) * nh, acts + (k - 1) * nh, h, act};
      sgemm_w<PREC>(n, in_dims[k], out_dims[k], deltas + k * nh, h, W[k],
                    ldw[k], true, prep, ep, stream);
    } else {
      const DhEpi ep = {deltas + (k - 1) * nh, h, acts + (k - 1) * nh, h, act};
      sgemm_w<PREC>(n, in_dims[k], out_dims[k], deltas + k * nh, h, W[k],
                    ldw[k], true, prep, ep, stream);
    }
  }
  // 3. g = d_0 @ W_0, R = eps - sigma * g, loss = sum(R^2) / N
  const ResidEpi ep = {R, sigma, eps, d};
  sgemm_w<PREC>(n, d, out_dims[0], deltas, h, W[0], ldw[0], true, prep, ep,
                stream);
  sumsq_partial_kernel<<<LOSS_BLOCKS, 256, 0, stream>>>(R, (long long)n * d,
                                                        scratch);
  loss_final_kernel<<<1, 256, 0, stream>>>(scratch, LOSS_BLOCKS,
                                           1.f / ((float)n * (float)d), loss);
  return launch_status();
}

template <int PREC>
int grad_bwd(int n, int d, int ssz, int n_layers, int l0, int act,
             const float* xbar, const float* sigma, const float* R,
             const float* g, const float* const* W, const int* in_dims,
             const int* out_dims, const int* ldw, const float* acts,
             const float* deltas, int h, float* const* dW, float* const* dB,
             float* dctx, int ctx_ld, float* tan0, float* tans, float* curvs,
             float* ap0, float* ap1, float* scratch, cudaStream_t stream) {
  const int top = n_layers - 2;
  const long long nh = (long long)n * h;
  const long long total = (long long)n * d;
  float* prep = scratch;   // each product's weight, converted (prep_b)
  scratch += prep_floats(n_layers, in_dims, out_dims);
  constexpr bool bf16 = PREC == PREC_BF16;
  float* bufs[2] = {ap0, ap1};
  // 4. tangent chain along w (bf16: at a unit cotangent, every gradient
  // scaled by g at the end, as the TPU kernels' VJP scales them)
  tangent_seed_kernel<<<cdiv(total, 256), 256, 0, stream>>>(
      R, sigma, bf16 ? nullptr : g, total, d, 1.f / ((float)n * (float)d),
      tan0);
  const float* tin = tan0;
  int tin_ld = d;
  for (int k = 0; k <= top; ++k) {
    if constexpr (bf16) {
      float* tnext = k < l0 ? bufs[k & 1] : nullptr;
      const TangentEpiBF16 ep = {tans + k * nh,   tnext, curvs + k * nh,
                                 acts + k * nh,   deltas + k * nh,
                                 h,               act,   k == top};
      sgemm_w<PREC>(n, out_dims[k], in_dims[k], tin, tin_ld, W[k], ldw[k],
                    false, prep, ep, stream);
      tin = tnext ? tnext : tans + k * nh;
    } else {
      const TangentEpi ep = {tans + k * nh, curvs + k * nh, acts + k * nh,
                             deltas + k * nh, h, act};
      sgemm_w<PREC>(n, out_dims[k], in_dims[k], tin, tin_ld, W[k], ldw[k],
                    false, prep, ep, stream);
      tin = tans + k * nh;
    }
    tin_ld = h;
  }
  // the energy head: d w_out = sum_rows tu_L-1; b_out does not reach the score
  colsum(tans + top * nh, n, h, h, nullptr, scratch, dW[n_layers - 1], 1, stream);
  cudaMemsetAsync(dB[n_layers - 1], 0, sizeof(float), stream);
  // 5. reverse over the primal (Ap) and tangent (d) chains
  const float* ap = curvs + top * nh;   // A_L-2 = 0: Ap_L-2 = c_L-2
  for (int k = top; k >= 0; --k) {
    const int out = out_dims[k], in = in_dims[k];
    const float* u_in = k == 0 ? xbar : acts + (k - 1) * nh;
    const float* t_in = k == 0 ? tan0 : tans + (k - 1) * nh;
    const int in_ld = k == 0 ? d : h;
    // dW[:, :in] = Ap^T u + d^T tu: both products' split-K partials, one
    // fixed-order sum
    const int S = wgrad_splits(out, in, n);
    wgrad_partials<PREC>(out, in, n, S, ap, h, u_in, in_ld, scratch, stream);
    wgrad_partials<PREC>(out, in, n, S, deltas + k * nh, h, t_in, in_ld,
                         scratch + (long long)S * out * in, stream);
    reduce_splits(scratch, 2 * S, out, in, dW[k], ldw[k], 1, stream);
    colsum(ap, n, out, h, nullptr, scratch, dB[k], 1, stream);
    if (k == l0) {
      colsum(ap, n, out, h, sigma, scratch, dW[k] + in, ldw[k], stream);
      seg_colsum(ap, n, out, h, ssz, nullptr, dctx, ctx_ld, stream);
    }
    if (k > 0) {
      float* next = bufs[k & 1];
      const std::conditional_t<bf16, RevEpiBF16, RevEpi> ep = {
          next, acts + (k - 1) * nh, curvs + (k - 1) * nh, h, act};
      sgemm_w<PREC>(n, in, out, ap, h, W[k], ldw[k], true, prep, ep, stream);
      ap = next;
    }
  }
  if constexpr (bf16) {
    auto scale = [&](float* x, long long count) {
      scale_kernel<<<cdiv(count, 256), 256, 0, stream>>>(x, count, g);
    };
    for (int k = 0; k < n_layers; ++k) {
      scale(dW[k], (long long)out_dims[k] * ldw[k]);
      scale(dB[k], out_dims[k]);
    }
    scale(dctx, (long long)(n / ssz) * ctx_ld);
  }
  return launch_status();
}

}  // namespace
