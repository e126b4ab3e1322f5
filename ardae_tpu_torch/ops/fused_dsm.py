"""Fused denoising-score-matching loss of the res-style conditional AR-DAE
(the phase-A hot op), bound to the hand-written Hopper kernel in
``csrc/fused_dsm.cu``.

JAX twin: ardae_tpu/ops/fused_dsm.py (``fused_cdae_dsm_loss`` around the
Pallas ``_fwd_kernel``/``_bwd_kernel``). Same math:

    inp   = MLP_enc(x_bar)                       (E layers, act everywhere)
    h0    = act(inp @ W_h + sigma * w_s + b0 + ctx_l0[item])
    h_k   = act(h_{k-1} @ W_k + b_k)             (H hidden layers)
    r     = h_H @ W_out + b_out
    loss  = mean((sigma * r + eps)^2)

Differences from the TPU kernel: the context contribution enters as
(bsz, h) and its gradient comes back reduced to (bsz, h) (the TPU kernel
took and returned (n, h) rows); the row count need not divide any tile.

Dispatch: on a CPU tensor ``fused_cdae_dsm_loss`` runs the plain-PyTorch
``fused_cdae_dsm_loss_reference``; on a CUDA tensor it launches the kernel
or raises. There is no fallback.
"""

import ctypes
import functools

import torch

from ardae_tpu_torch.models.cdae.cardae import dsm_noise, perturb
from ardae_tpu_torch.ops import native
from ardae_tpu_torch.utils.tracing import span

ACTS = {"softplus": 0, "relu": 1, "tanh": 2}

# The activation workspace the forward keeps for the backward,
# (layers - 1) x n x h fp32; the guard caps it (1.6 GB at the flagship).
MAX_WORKSPACE_BYTES = 16 << 30


@functools.lru_cache(maxsize=1)
def build_library():
    """Compile ``csrc/fused_dsm.cu`` for sm_90a into ``build/`` (once per
    source change) and load it. Returns (ctypes library, build info dict)."""
    lib, info = native.load("fused_dsm")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fused_dsm_scratch_floats.argtypes = [i, i, p, p]
    lib.fused_dsm_scratch_floats.restype = ll
    lib.fused_dsm_fwd.argtypes = (
        [i] * 6 + [p, p, p, p, i, p, p, p, p, p, p, i, p, p, p, p])
    lib.fused_dsm_fwd.restype = i
    lib.fused_dsm_bwd.argtypes = (
        [i] * 6 + [p, p, p, p, p, p, p, p, p, i, p, p, p, p, i, p, p, p, p])
    lib.fused_dsm_bwd.restype = i
    native.bind_core(lib)
    return lib, info


def flat_weights(module):
    """CARDAE (conditional, split trunk, either style) -> [W0, b0, ...,
    Wout, bout], torch layout; l0's weight keeps sigma's column as its
    last. Also returns l0's index."""
    layers = list(module.inp_encode.layers) + [module.inp_encode.fc,
                                               module.l0_row]
    layers += list(module.trunk_rest.layers) + [module.trunk_rest.fc]
    flat = []
    for lin in layers:
        flat += [lin.weight, lin.bias]
    return flat, len(module.inp_encode.layers) + 1


class FusedDSMFunction(torch.autograd.Function):
    """Kernel-backed DSM chain. Inputs: act name, l0 index, xbar (n, d),
    eps (n, d), sigma (n, 1), ctx_l0 (bsz, h), then the flat weights.
    ``launches`` counts the forward and backward entry points launched."""

    launches = {"fused_dsm_fwd": 0, "fused_dsm_bwd": 0}

    @staticmethod
    def forward(ctx, act, l0, xbar, eps, sigma, ctx_l0, *flat):
        lib, _ = build_library()
        for name, t in [("xbar", xbar), ("eps", eps), ("sigma", sigma),
                        ("ctx_l0", ctx_l0)] + [(f"weight {k}", w)
                                               for k, w in enumerate(flat)]:
            native.check_operand(t, name)
        n, d = xbar.shape
        bsz, h = ctx_l0.shape
        if n % bsz:
            raise ValueError(f"rows {n} are not a whole number of items {bsz}")
        ws, bs = flat[0::2], flat[1::2]
        out_dims = [w.shape[0] for w in ws]
        in_dims = [w.shape[1] for w in ws]
        ldw = list(in_dims)
        in_dims[l0] -= 1  # sigma's column
        L = len(ws)
        dev = xbar.device
        acts = torch.empty((L - 1, n, h), device=dev)
        r = torch.empty((n, d), device=dev)
        loss = torch.empty((), device=dev)
        n_scratch = lib.fused_dsm_scratch_floats(n, L, native.int_array(in_dims),
                                                 native.int_array(out_dims))
        scratch = torch.empty(n_scratch, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        with span("fused_dsm_fwd"):  # its name in a trace
            err = lib.fused_dsm_fwd(
                n, d, n // bsz, L, l0, ACTS[act], xbar.data_ptr(), eps.data_ptr(),
                sigma.data_ptr(), ctx_l0.data_ptr(), h, native.ptr_array(ws), native.ptr_array(bs),
                native.int_array(in_dims), native.int_array(out_dims), native.int_array(ldw), acts.data_ptr(), h,
                r.data_ptr(), scratch.data_ptr(), loss.data_ptr(), stream)
        if err:
            raise RuntimeError(f"fused_dsm_fwd launch failed: CUDA error {err}")
        FusedDSMFunction.launches["fused_dsm_fwd"] += 1
        ctx.act, ctx.l0, ctx.bsz = act, l0, bsz
        ctx.dims = (in_dims, out_dims, ldw, n_scratch)
        ctx.save_for_backward(xbar, eps, sigma, acts, r, *ws)
        return loss

    @staticmethod
    def backward(ctx, g):
        lib, _ = build_library()
        xbar, eps, sigma, acts, r, *ws = ctx.saved_tensors
        in_dims, out_dims, ldw, n_scratch = ctx.dims
        n, d = xbar.shape
        h = acts.shape[-1]
        dev = xbar.device
        g = g.to(torch.float32).contiguous()
        dws = [torch.empty_like(w) for w in ws]
        dbs = [torch.empty(w.shape[0], device=dev) for w in ws]
        dctx = torch.empty((ctx.bsz, h), device=dev)
        width = max(max(out_dims), max(in_dims))
        dp0 = torch.empty((n, width), device=dev)
        dp1 = torch.empty((n, width), device=dev)
        scratch = torch.empty(n_scratch, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        with span("fused_dsm_bwd"):  # its name in a trace
            err = lib.fused_dsm_bwd(
                n, d, n // ctx.bsz, len(ws), ctx.l0, ACTS[ctx.act],
                xbar.data_ptr(), eps.data_ptr(), sigma.data_ptr(), g.data_ptr(),
                native.ptr_array(ws), native.int_array(in_dims), native.int_array(out_dims), native.int_array(ldw),
                acts.data_ptr(), h, r.data_ptr(), native.ptr_array(dws), native.ptr_array(dbs),
                dctx.data_ptr(), h, dp0.data_ptr(), dp1.data_ptr(),
                scratch.data_ptr(), stream)
        if err:
            raise RuntimeError(f"fused_dsm_bwd launch failed: CUDA error {err}")
        FusedDSMFunction.launches["fused_dsm_bwd"] += 1
        flat_grads = []
        for dw, db in zip(dws, dbs):
            flat_grads += [dw, db]
        return (None, None, None, None, None, dctx, *flat_grads)


def chain_reference(act, l0, x, sigma, ctx_l0, flat):
    """The layer chain of both DSM kernels in plain PyTorch: x (n, d) through
    every layer of ``flat`` (act after all but the last), l0 split as in
    ``CARDAE``; returns the last layer's output."""
    from ardae_tpu_torch.nn.activations import get_nonlinear_func

    afun = get_nonlinear_func(act)
    n = x.shape[0]
    bsz, hdim = ctx_l0.shape
    h = x
    ws, bs = flat[0::2], flat[1::2]
    for i, (w, b) in enumerate(zip(ws, bs)):
        if i == l0:
            pre = h @ w[:, :-1].T + sigma * w[:, -1] + b
            pre = (pre.reshape(bsz, n // bsz, hdim) + ctx_l0[:, None, :]).reshape(n, hdim)
        else:
            pre = h @ w.T + b
        h = pre if i == len(ws) - 1 else afun(pre)
    return h


def dsm_chain_reference(act, l0, xbar, eps, sigma, ctx_l0, *flat):
    """The kernel's function in plain PyTorch; autograd gives its gradients."""
    r = chain_reference(act, l0, xbar, sigma, ctx_l0, flat)
    return torch.mean((sigma * r + eps) ** 2)


def dsm_chain(act, l0, xbar, eps, sigma, ctx_l0, *flat):
    """Kernel on a CUDA tensor, plain version on a CPU tensor, else raise."""
    if xbar.is_cuda:
        return FusedDSMFunction.apply(act, l0, xbar, eps, sigma, ctx_l0, *flat)
    if xbar.device.type == "cpu":
        return dsm_chain_reference(act, l0, xbar, eps, sigma, ctx_l0, *flat)
    raise RuntimeError(f"fused DSM: no kernel for device {xbar.device}")


def supports_fused_dsm(module, n_rows):
    """The kernel covers the res-style, conditional, sigma-conditioned,
    enc_input CARDAE with a softplus, relu or tanh activation, in fp32, for
    any row count. Its tiles (tensor-core GEMM blocks of 128x128x32, whose
    3-stage ring takes 99-120 KB of the 227 KB of shared memory a block may
    have, whatever the width; 32-column sums) loop over every dimension and
    mask the edges, so they bound no width; the bound is the activation
    workspace the forward keeps for the backward, (layers - 1) x n_rows x h
    x 4 B, capped at MAX_WORKSPACE_BYTES."""
    if not (getattr(module, "score_type", None) == "res" and module.conditional
            and module.sigma_conditioned and module.enc_input
            and module.nonlinearity in ACTS):
        return False
    if any(p.dtype != torch.float32 for p in module.parameters()):
        return False
    layers = 2 * module.num_hidden_layers + 1
    return (layers - 1) * n_rows * module.h_dim * 4 <= MAX_WORKSPACE_BYTES


def prepare_inputs(module, latent, context, std, generator, eps,
                   noise_type="gaussian"):
    """The DSM kernels' arguments for a CARDAE (see ``fused_cdae_dsm_loss``):
    (act, l0, xbar, eps, sigma, ctx_l0, flat weights); ``xbar`` and ``eps``
    formed as ``cdae_loss`` forms them for ``noise_type``."""
    bsz, ssz, d = latent.shape
    n = bsz * ssz
    x = latent.reshape(n, d).to(torch.float32)
    sigma = torch.as_tensor(std, dtype=torch.float32, device=x.device)
    sigma = sigma.expand(bsz, ssz, 1).reshape(n, 1).contiguous()
    eps = dsm_noise((n, d), generator, eps, x.device, noise_type).contiguous()
    xbar = perturb(x, sigma, eps, noise_type).contiguous()
    ctx_l0 = module.ctx_l0(context)
    flat, l0 = flat_weights(module)
    return module.nonlinearity, l0, xbar, eps, sigma, ctx_l0, flat


def fused_cdae_dsm_loss(module, latent, context, std, generator=None, eps=None,
                        noise_type="gaussian"):
    """Drop-in for ``cdae_loss`` on supported configs, with any of its
    noises: the kernel takes x_bar and the loss target eps as inputs, so
    Laplace and uniform noise change only ``prepare_inputs``. (The JAX
    package runs XLA's cdae_loss for such noise, train/step.py:191; the
    kernel computes the same function.)

    latent (bsz, ssz, d), context (bsz, ctx_dim), std (bsz, ssz, 1); ``eps``
    the injected DSM noise (n, d), else drawn from ``generator``. Gradients
    reach every weight and, through d/d(ctx_l0), the context encoder;
    latent, context and std are constants (phase A detaches them)."""
    act, l0, xbar, eps, sigma, ctx_l0, flat = prepare_inputs(
        module, latent, context, std, generator, eps, noise_type)
    return dsm_chain(act, l0, xbar, eps, sigma, ctx_l0, *flat)


def fused_cdae_dsm_loss_reference(module, latent, context, std, generator=None,
                                  eps=None, noise_type="gaussian"):
    """``fused_cdae_dsm_loss`` in plain PyTorch on any device."""
    act, l0, xbar, eps, sigma, ctx_l0, flat = prepare_inputs(
        module, latent, context, std, generator, eps, noise_type)
    return dsm_chain_reference(act, l0, xbar, eps, sigma, ctx_l0, *flat)
