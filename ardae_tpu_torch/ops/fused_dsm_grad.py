"""Fused second-order denoising-score-matching loss of the gradient-style
conditional AR-DAE (score = -d e / d x_bar of a scalar energy MLP), the
phase-A hot op of the implicit-conv line, bound to the hand-written Hopper
kernel in ``csrc/fused_dsm_grad.cu``.

JAX twins: ardae_tpu/ops/fused_dsm_grad.py (``fused_cdae_dsm_grad_loss``)
and ardae_tpu/ops/fused_dsm_grad2.py (``fused_cdae_dsm_grad_loss2``), two
TPU layouts of one function. Same math:

    s     = -d e(x_bar, ctx, sigma) / d x_bar     (e: enc MLP, split l0,
                                                   trunk, h -> 1 head)
    loss  = mean((sigma * s + eps)^2)
    d loss / d theta                              (second order)

The context contribution enters as ctx_l0 (bsz, h) and its gradient leaves
reduced to (bsz, h), as in the v2 TPU kernel; the row count need not divide
any tile. The kernel is fp32 only: the second-order tangents are ~1e-9 early
in training and lose to bf16 rounding (ops/fused_dsm_grad.py:42-45).

Dispatch: on a CPU tensor ``fused_cdae_dsm_grad_loss`` runs the
plain-PyTorch ``fused_cdae_dsm_grad_loss_reference``; on a CUDA tensor it
launches the kernel or raises. There is no fallback.
"""

import ctypes
import functools

import torch

from ardae_tpu_torch.ops import native
from ardae_tpu_torch.ops.fused_dsm import (
    ACTS,
    MAX_WORKSPACE_BYTES,
    chain_reference,
    prepare_inputs,
)


@functools.lru_cache(maxsize=1)
def build_library():
    """Compile ``csrc/fused_dsm_grad.cu`` for sm_90a into ``build/`` (once
    per source change) and load it. Returns (ctypes library, build info)."""
    lib, info = native.load("fused_dsm_grad")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fused_dsm_grad_scratch_floats.argtypes = [i, i, p, p]
    lib.fused_dsm_grad_scratch_floats.restype = ll
    lib.fused_dsm_grad_fwd.argtypes = (
        [i] * 6 + [p] * 4 + [i] + [p] * 7 + [i] + [p] * 4)
    lib.fused_dsm_grad_fwd.restype = i
    lib.fused_dsm_grad_bwd.argtypes = (
        [i] * 6 + [p] * 10 + [i] + [p] * 3 + [i] + [p] * 7)
    lib.fused_dsm_grad_bwd.restype = i
    return lib, info


def _dims(flat, l0, d, h):
    ws = flat[0::2]
    out_dims = [w.shape[0] for w in ws]
    in_dims = [w.shape[1] for w in ws]
    ldw = list(in_dims)
    in_dims[l0] -= 1  # sigma's column
    if (in_dims[0] != d or out_dims[-1] != 1 or in_dims[-1] != h
            or any(o != h for o in out_dims[:-1])):
        raise ValueError(f"fused DSM grad kernel: the layers must take d={d} "
                         f"to h={h} wide hidden layers and an h -> 1 head, got "
                         f"{list(zip(in_dims, out_dims))}")
    return in_dims, out_dims, ldw


class FusedDSMGradFunction(torch.autograd.Function):
    """Kernel-backed second-order DSM chain. Inputs: act name, l0 index,
    xbar (n, d), eps (n, d), sigma (n, 1), ctx_l0 (bsz, h), then the flat
    weights. ``launches`` counts the forward and backward entry points
    launched."""

    launches = {"fused_dsm_grad_fwd": 0, "fused_dsm_grad_bwd": 0}

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
        in_dims, out_dims, ldw = _dims(flat, l0, d, h)
        L = len(ws)
        dev = xbar.device
        acts = torch.empty((L - 1, n, h), device=dev)
        deltas = torch.empty((L - 1, n, h), device=dev)
        resid = torch.empty((n, d), device=dev)
        loss = torch.empty((), device=dev)
        n_scratch = lib.fused_dsm_grad_scratch_floats(
            n, L, native.int_array(in_dims), native.int_array(out_dims))
        scratch = torch.empty(n_scratch, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_dsm_grad_fwd(
            n, d, n // bsz, L, l0, ACTS[act], xbar.data_ptr(), eps.data_ptr(),
            sigma.data_ptr(), ctx_l0.data_ptr(), h, native.ptr_array(ws),
            native.ptr_array(bs), native.int_array(in_dims),
            native.int_array(out_dims), native.int_array(ldw),
            acts.data_ptr(), deltas.data_ptr(), h, resid.data_ptr(),
            scratch.data_ptr(), loss.data_ptr(), stream)
        if err:
            raise RuntimeError(f"fused_dsm_grad_fwd launch failed: CUDA error {err}")
        FusedDSMGradFunction.launches["fused_dsm_grad_fwd"] += 1
        ctx.act, ctx.l0, ctx.bsz = act, l0, bsz
        ctx.dims = (in_dims, out_dims, ldw, n_scratch)
        ctx.save_for_backward(xbar, sigma, acts, deltas, resid, *ws)
        return loss

    @staticmethod
    def backward(ctx, g):
        lib, _ = build_library()
        xbar, sigma, acts, deltas, resid, *ws = ctx.saved_tensors
        in_dims, out_dims, ldw, n_scratch = ctx.dims
        n, d = xbar.shape
        h = acts.shape[-1]
        dev = xbar.device
        g = g.to(torch.float32).contiguous()
        dws = [torch.empty_like(w) for w in ws]
        dbs = [torch.empty(w.shape[0], device=dev) for w in ws]
        dctx = torch.empty((ctx.bsz, h), device=dev)
        tan0 = torch.empty((n, d), device=dev)
        tans = torch.empty_like(acts)
        curvs = torch.empty_like(acts)
        ap0 = torch.empty((n, h), device=dev)
        ap1 = torch.empty((n, h), device=dev)
        scratch = torch.empty(n_scratch, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_dsm_grad_bwd(
            n, d, n // ctx.bsz, len(ws), ctx.l0, ACTS[ctx.act],
            xbar.data_ptr(), sigma.data_ptr(), resid.data_ptr(), g.data_ptr(),
            native.ptr_array(ws), native.int_array(in_dims),
            native.int_array(out_dims), native.int_array(ldw),
            acts.data_ptr(), deltas.data_ptr(), h, native.ptr_array(dws),
            native.ptr_array(dbs), dctx.data_ptr(), h, tan0.data_ptr(),
            tans.data_ptr(), curvs.data_ptr(), ap0.data_ptr(), ap1.data_ptr(),
            scratch.data_ptr(), stream)
        if err:
            raise RuntimeError(f"fused_dsm_grad_bwd launch failed: CUDA error {err}")
        FusedDSMGradFunction.launches["fused_dsm_grad_bwd"] += 1
        flat_grads = []
        for dw, db in zip(dws, dbs):
            flat_grads += [dw, db]
        return (None, None, None, None, None, dctx, *flat_grads)


def dsm_grad_chain_reference(act, l0, xbar, eps, sigma, ctx_l0, *flat):
    """The kernel's function in plain PyTorch: the energy chain, its input
    gradient through ``torch.autograd.grad(create_graph=True)``, and autograd
    for the second-order parameter gradients (the head's bias gets none)."""
    with torch.enable_grad():
        x = xbar.detach().requires_grad_(True)
        energy = chain_reference(act, l0, x, sigma, ctx_l0, flat)
        (g,) = torch.autograd.grad(energy.sum(), x, create_graph=True)
    return torch.mean((eps - sigma * g) ** 2)


def dsm_grad_chain(act, l0, xbar, eps, sigma, ctx_l0, *flat):
    """Kernel on a CUDA tensor, plain version on a CPU tensor, else raise."""
    if xbar.is_cuda:
        return FusedDSMGradFunction.apply(act, l0, xbar, eps, sigma, ctx_l0, *flat)
    if xbar.device.type == "cpu":
        return dsm_grad_chain_reference(act, l0, xbar, eps, sigma, ctx_l0, *flat)
    raise RuntimeError(f"fused DSM grad: no kernel for device {xbar.device}")


def workspace_bytes(module, n_rows):
    """The kernel's activation workspace: u, d (forward) and tu, c
    (backward), each (layers - 1) x n_rows x h fp32."""
    layers = 2 * module.num_hidden_layers + 1
    return 4 * (layers - 1) * n_rows * module.h_dim * 4


def supports_fused_dsm_grad(module, n_rows):
    """The kernel covers the grad-style, conditional, sigma-conditioned,
    enc_input CARDAE with a softplus, relu or tanh activation, in fp32, for
    any row count and width: its tiles (tensor-core GEMM blocks of
    128x128x32, whose 3-stage ring takes 99-120 KB of the 227 KB of shared
    memory a block may have, whatever the width; 32-column sums) loop over
    every dimension and mask the edges. The bound is the workspace
    (``workspace_bytes``), capped at MAX_WORKSPACE_BYTES (3.3 GB at the
    implicit-conv line)."""
    if not (getattr(module, "score_type", None) == "grad" and module.conditional
            and module.sigma_conditioned and module.enc_input
            and module.nonlinearity in ACTS):
        return False
    if any(p.dtype != torch.float32 for p in module.parameters()):
        return False
    return workspace_bytes(module, n_rows) <= MAX_WORKSPACE_BYTES


def fused_cdae_dsm_grad_loss(module, latent, context, std, generator=None,
                             eps=None):
    """Drop-in for ``cdae_loss`` (gaussian noise, grad style) on supported
    configs.

    latent (bsz, ssz, d), context (bsz, ctx_dim), std (bsz, ssz, 1); ``eps``
    the injected DSM noise (n, d), else drawn from ``generator``. Gradients
    reach every weight and, through d/d(ctx_l0), the context encoder;
    latent, context and std are constants (phase A detaches them)."""
    act, l0, xbar, eps, sigma, ctx_l0, flat = prepare_inputs(
        module, latent, context, std, generator, eps)
    return dsm_grad_chain(act, l0, xbar, eps, sigma, ctx_l0, *flat)


def fused_cdae_dsm_grad_loss_reference(module, latent, context, std,
                                       generator=None, eps=None):
    """``fused_cdae_dsm_grad_loss`` in plain PyTorch on any device."""
    act, l0, xbar, eps, sigma, ctx_l0, flat = prepare_inputs(
        module, latent, context, std, generator, eps)
    return dsm_grad_chain_reference(act, l0, xbar, eps, sigma, ctx_l0, *flat)
