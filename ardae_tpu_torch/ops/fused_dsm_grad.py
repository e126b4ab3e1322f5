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
any tile.

``compute_dtype`` is either TPU kernel's compute mode: ``"float32"``, every
product fp32-accurate, or ``"bfloat16"``, rounded to bf16 where the TPU
row-tile kernel rounds in that mode: every product's operands (the weight
matrices, w_out and sigma's weight among them, the activations, the tangent
direction, the tangent and adjoint chains), the stored pre-activations and
tangent products that phi, phi' and phi'' are taken from, and the primal
adjoints that the bias, sigma and ctx gradients sum; fp32 accumulation, and
biases, sigma, eps, the ctx rows, the loss and the gradient sums in fp32.
(The item-aligned kernel rounds a few values otherwise, so its bf16
gradients differ from the row-tile kernel's.) The TPU kernels default to
bf16; the port defaults to fp32, because its train step dispatches this
kernel (JAX's never does, ardae_tpu/train/step.py:181-184), every caller
of the port relies on fp32, and fp32 is the only mode the JAX docstring
trusts: the second-order tangents are ~1e-9 early in training and lose to
bf16 rounding (ardae_tpu/ops/fused_dsm_grad.py:42-45). The train step never
asks for bf16.

Dispatch: on a CPU tensor ``fused_cdae_dsm_grad_loss`` runs the
plain-PyTorch ``fused_cdae_dsm_grad_loss_reference`` in the asked mode; on a
CUDA tensor it launches the kernel in that mode or raises. There is no
fallback.
"""

import ctypes
import functools

import torch

from ardae_tpu_torch.nn.activations import get_nonlinear_func
from ardae_tpu_torch.ops import native
from ardae_tpu_torch.ops.fused_dsm import (
    ACTS,
    MAX_WORKSPACE_BYTES,
    chain_reference,
    prepare_inputs,
)
from ardae_tpu_torch.utils.tracing import span

# the kernel's precision argument of each compute mode (csrc Prec)
COMPUTE_DTYPES = {"float32": 0, "bfloat16": 1}


def _check_compute_dtype(compute_dtype):
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"fused DSM grad: compute_dtype must be one of "
                         f"{sorted(COMPUTE_DTYPES)}, got {compute_dtype!r}")


@functools.lru_cache(maxsize=1)
def build_library():
    """Compile ``csrc/fused_dsm_grad.cu`` for sm_90a into ``build/`` (once
    per source change) and load it. Returns (ctypes library, build info)."""
    lib, info = native.load("fused_dsm_grad")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fused_dsm_grad_scratch_floats.argtypes = [i, i, p, p]
    lib.fused_dsm_grad_scratch_floats.restype = ll
    lib.fused_dsm_grad_fwd.argtypes = (
        [i] * 7 + [p] * 4 + [i] + [p] * 7 + [i] + [p] * 4)
    lib.fused_dsm_grad_fwd.restype = i
    lib.fused_dsm_grad_bwd.argtypes = (
        [i] * 7 + [p] * 10 + [i] + [p] * 3 + [i] + [p] * 7)
    lib.fused_dsm_grad_bwd.restype = i
    native.bind_core(lib)
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


def _launch_forward(fn, ctx, act, l0, xbar, eps, sigma, ctx_l0, flat):
    """The forward entry point in ``fn``'s compute mode; counts the launch
    under ``fn``'s forward name."""
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
    entry, _ = fn.launches  # its (forward, backward) names, in order
    with span(entry):  # its name in a trace
        err = lib.fused_dsm_grad_fwd(
            n, d, n // bsz, L, l0, ACTS[act], COMPUTE_DTYPES[fn.compute_dtype],
            xbar.data_ptr(), eps.data_ptr(), sigma.data_ptr(), ctx_l0.data_ptr(),
            h, native.ptr_array(ws), native.ptr_array(bs),
            native.int_array(in_dims), native.int_array(out_dims),
            native.int_array(ldw), acts.data_ptr(), deltas.data_ptr(), h,
            resid.data_ptr(), scratch.data_ptr(), loss.data_ptr(), stream)
    if err:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    fn.launches[entry] += 1
    ctx.act, ctx.l0, ctx.bsz = act, l0, bsz
    ctx.dims = (in_dims, out_dims, ldw, n_scratch)
    ctx.save_for_backward(xbar, sigma, acts, deltas, resid, *ws)
    return loss


def _launch_backward(fn, ctx, g):
    """The backward entry point in ``fn``'s compute mode; counts the launch
    under ``fn``'s backward name. Returns ``fn.backward``'s gradients."""
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
    _, entry = fn.launches  # its (forward, backward) names, in order
    with span(entry):  # its name in a trace
        err = lib.fused_dsm_grad_bwd(
            n, d, n // ctx.bsz, len(ws), ctx.l0, ACTS[ctx.act],
            COMPUTE_DTYPES[fn.compute_dtype], xbar.data_ptr(), sigma.data_ptr(),
            resid.data_ptr(), g.data_ptr(), native.ptr_array(ws),
            native.int_array(in_dims), native.int_array(out_dims),
            native.int_array(ldw), acts.data_ptr(), deltas.data_ptr(), h,
            native.ptr_array(dws), native.ptr_array(dbs), dctx.data_ptr(), h,
            tan0.data_ptr(), tans.data_ptr(), curvs.data_ptr(), ap0.data_ptr(),
            ap1.data_ptr(), scratch.data_ptr(), stream)
    if err:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    fn.launches[entry] += 1
    flat_grads = []
    for dw, db in zip(dws, dbs):
        flat_grads += [dw, db]
    return (None, None, None, None, None, dctx, *flat_grads)


def _make_function(name, compute_dtype, launches):
    """The kernel-backed second-order DSM chain in one compute mode, as an
    autograd function. Inputs: act name, l0 index, xbar (n, d), eps (n, d),
    sigma (n, 1), ctx_l0 (bsz, h), then the flat weights. ``launches``
    counts the forward and backward entry points launched in this mode
    only, under names of its own, so that the two modes count apart."""

    def forward(ctx, act, l0, xbar, eps, sigma, ctx_l0, *flat):
        return _launch_forward(fn, ctx, act, l0, xbar, eps, sigma, ctx_l0, flat)

    def backward(ctx, g):
        return _launch_backward(fn, ctx, g)

    fn = type(name, (torch.autograd.Function,), {
        "__doc__": f"The fused DSM grad kernel, its products in {compute_dtype}.",
        "compute_dtype": compute_dtype,
        "launches": dict.fromkeys(launches, 0),
        "forward": staticmethod(forward), "backward": staticmethod(backward)})
    return fn


FusedDSMGradFunction = _make_function(
    "FusedDSMGradFunction", "float32",
    ("fused_dsm_grad_fwd", "fused_dsm_grad_bwd"))
FusedDSMGradBF16Function = _make_function(
    "FusedDSMGradBF16Function", "bfloat16",
    ("fused_dsm_grad_fwd_bf16", "fused_dsm_grad_bwd_bf16"))
# the kernel-backed function of each compute mode
FUNCTIONS = {"float32": FusedDSMGradFunction,
             "bfloat16": FusedDSMGradBF16Function}


def _bf16(x):
    """x rounded to the nearest bf16 (ties to even), back in fp32."""
    return x.to(torch.bfloat16).float()


def _bf16_mm(a, b):
    """a @ b with both operands rounded to bf16, an fp32 product: one of
    the kernel's products in its bf16 mode."""
    return _bf16(a) @ _bf16(b)


def _act_factors(act):
    """phi, phi' of the pre-activation, and phi' and phi''/phi' from the
    post-activation u = phi(pre), as the kernel takes them
    (csrc/fused_dsm_grad.cu act_grad_from_pre, csrc/dsm_sgemm.cuh
    act_grad_from_out, act_curv_from_out)."""
    phi = get_nonlinear_func(act)
    if act == "softplus":
        return (phi, torch.sigmoid, lambda u: -torch.expm1(-u),
                lambda u: torch.exp(-u))
    if act == "relu":
        return (phi, lambda z: (z > 0).float(), lambda u: (u > 0).float(),
                torch.zeros_like)
    if act == "tanh":
        return (phi, lambda z: 1.0 - torch.tanh(z) ** 2, lambda u: 1.0 - u * u,
                lambda u: -2.0 * u)
    raise ValueError(f"fused DSM grad: no activation {act!r}")


class _PlainBF16Chain(torch.autograd.Function):
    """The kernel's bf16 mode in plain PyTorch, step by step as
    csrc/fused_dsm_grad.cu computes it, rounding (``_bf16``) where the TPU
    row-tile kernel rounds in its bf16 mode (ardae_tpu/ops/
    fused_dsm_grad.py:135-256): every product's operands, the stored
    pre-activations zb and tangent products tzb that phi, phi' and phi''
    are taken from, w_out and sigma's weight, and the primal adjoints ap;
    every other operation in fp32. The gradients are taken at a unit
    cotangent and scaled by it at the end, as the TPU kernel's VJP does.
    Inputs as ``FusedDSMGradFunction``'s."""

    @staticmethod
    def forward(ctx, act, l0, xbar, eps, sigma, ctx_l0, *flat):
        phi, dphi_pre, _, _ = _act_factors(act)
        ws, bs = flat[0::2], flat[1::2]
        n, d = xbar.shape
        bsz, h = ctx_l0.shape
        top = len(ws) - 2
        w_in = [w[:, :-1] if k == l0 else w for k, w in enumerate(ws)]
        # 1. forward chain: the next input phi(z), zbs[k] = bf16(z_k)
        u, zbs = xbar, []
        for k in range(top + 1):
            z = _bf16_mm(u, w_in[k].T)
            if k == l0:
                z = z + sigma * _bf16(ws[k][:, -1]) + bs[k]
                z = (z.reshape(bsz, n // bsz, h) + ctx_l0[:, None, :]).reshape(n, h)
            else:
                z = z + bs[k]
            zbs.append(_bf16(z))
            u = phi(z)
        # the reverse's inputs: us[k + 1] = phi(zb_k), us[0] = xbar
        us = [xbar] + [phi(zb) for zb in zbs]
        # 2. input-gradient chain d_k, seeded by bf16(w_out)
        deltas = [None] * (top + 1)
        deltas[top] = _bf16(ws[-1][0]) * dphi_pre(zbs[top])
        for k in range(top, 0, -1):
            deltas[k - 1] = _bf16_mm(deltas[k], w_in[k]) * dphi_pre(zbs[k - 1])
        # 3. R = eps - sigma * d e / d xbar, loss = mean(R^2)
        resid = eps - sigma * _bf16_mm(deltas[0], w_in[0])
        ctx.act, ctx.l0, ctx.bsz = act, l0, bsz
        ctx.us, ctx.deltas = us, deltas
        ctx.save_for_backward(sigma, resid, *ws)
        return torch.mean(resid * resid)

    @staticmethod
    def backward(ctx, g):
        _, _, dphi, curv = _act_factors(ctx.act)
        sigma, resid, *ws = ctx.saved_tensors
        us, deltas, l0, bsz = ctx.us, ctx.deltas, ctx.l0, ctx.bsz
        n, d = resid.shape
        top = len(ws) - 2
        w_in = [w[:, :-1] if k == l0 else w for k, w in enumerate(ws)]
        # 4. tangent chain along w = -2 sigma R / N: tus[k + 1] the reverse's
        # input bf16(phi'(zb) * bf16(tz)); below l0 the next layer's input
        # is phi'(zb) * tz
        tus = [-2.0 * sigma * resid / (n * d)]
        curvs = []
        tin = tus[0]
        for k in range(top + 1):
            tz = _bf16_mm(tin, w_in[k].T)
            tzb = _bf16(tz)
            f = dphi(us[k + 1])
            tus.append(_bf16(f * tzb))
            c = deltas[k] * curv(us[k + 1]) * tzb
            curvs.append(_bf16(c) if k == top else c)
            tin = f * tz if k < l0 else tus[k + 1]
        # 5. reverse over the primal (ap) and tangent (d) chains
        grads = [None] * (2 * len(ws))
        grads[-2] = tus[top + 1].sum(0)[None, :]
        grads[-1] = torch.zeros_like(ws[-1][:, 0])
        dctx = None
        ap = curvs[top]
        for k in range(top, -1, -1):
            dw = _bf16_mm(ap.T, us[k]) + _bf16_mm(deltas[k].T, tus[k])
            if k == l0:
                dw = torch.cat([dw, (sigma * ap).sum(0)[:, None]], dim=1)
                dctx = ap.reshape(bsz, n // bsz, -1).sum(1)
            grads[2 * k], grads[2 * k + 1] = dw, ap.sum(0)
            if k > 0:
                ap = _bf16(_bf16_mm(ap, w_in[k]) * dphi(us[k]) + curvs[k - 1])
        return (None, None, None, None, None, g * dctx, *(g * x for x in grads))


def _chain_reference(compute_dtype, act, l0, xbar, eps, sigma, ctx_l0, *flat):
    if compute_dtype == "bfloat16":
        return _PlainBF16Chain.apply(act, l0, xbar, eps, sigma, ctx_l0, *flat)
    with torch.enable_grad():
        x = xbar.detach().requires_grad_(True)
        energy = chain_reference(act, l0, x, sigma, ctx_l0, flat)
        (g,) = torch.autograd.grad(energy.sum(), x, create_graph=True)
    return torch.mean((eps - sigma * g) ** 2)


def _chain(compute_dtype, act, l0, xbar, eps, sigma, ctx_l0, *flat):
    if xbar.is_cuda:
        return FUNCTIONS[compute_dtype].apply(act, l0, xbar, eps, sigma, ctx_l0,
                                              *flat)
    if xbar.device.type == "cpu":
        return _chain_reference(compute_dtype, act, l0, xbar, eps, sigma, ctx_l0,
                                *flat)
    raise RuntimeError(f"fused DSM grad: no kernel for device {xbar.device}")


def dsm_grad_chain_reference(act, l0, xbar, eps, sigma, ctx_l0, *flat,
                             compute_dtype="float32"):
    """The kernel's function in plain PyTorch. fp32: the energy chain, its
    input gradient through ``torch.autograd.grad(create_graph=True)``, and
    autograd for the second-order parameter gradients (the head's bias gets
    none). bf16: the kernel's steps, rounded where the kernel rounds
    (``_PlainBF16Chain``; the head's bias gets zeros, as from the kernel)."""
    _check_compute_dtype(compute_dtype)
    return _chain_reference(compute_dtype, act, l0, xbar, eps, sigma, ctx_l0,
                            *flat)


def dsm_grad_chain(act, l0, xbar, eps, sigma, ctx_l0, *flat,
                   compute_dtype="float32"):
    """Kernel in ``compute_dtype`` on a CUDA tensor, plain version on a CPU
    tensor, else raise."""
    _check_compute_dtype(compute_dtype)
    return _chain(compute_dtype, act, l0, xbar, eps, sigma, ctx_l0, *flat)


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
                             eps=None, noise_type="gaussian",
                             compute_dtype="float32"):
    """Drop-in for ``cdae_loss`` (grad style) on supported configs, with any
    of its noises: x_bar and the loss target eps are the kernel's inputs,
    formed by ``prepare_inputs`` for ``noise_type``. (The JAX package runs
    XLA's cdae_loss for Laplace and uniform noise, train/step.py:191; the
    kernel computes the same function.) ``compute_dtype``: the kernel's
    mode, "float32" (the default) or "bfloat16" (the TPU kernels' default;
    see the module docstring), anything else raises ValueError.

    latent (bsz, ssz, d), context (bsz, ctx_dim), std (bsz, ssz, 1); ``eps``
    the injected DSM noise (n, d), else drawn from ``generator``. Gradients
    reach every weight and, through d/d(ctx_l0), the context encoder;
    latent, context and std are constants (phase A detaches them)."""
    _check_compute_dtype(compute_dtype)
    act, l0, xbar, eps, sigma, ctx_l0, flat = prepare_inputs(
        module, latent, context, std, generator, eps, noise_type)
    return _chain(compute_dtype, act, l0, xbar, eps, sigma, ctx_l0, *flat)


def fused_cdae_dsm_grad_loss_reference(module, latent, context, std,
                                       generator=None, eps=None,
                                       noise_type="gaussian",
                                       compute_dtype="float32"):
    """``fused_cdae_dsm_grad_loss`` in plain PyTorch on any device."""
    _check_compute_dtype(compute_dtype)
    act, l0, xbar, eps, sigma, ctx_l0, flat = prepare_inputs(
        module, latent, context, std, generator, eps, noise_type)
    return _chain_reference(compute_dtype, act, l0, xbar, eps, sigma, ctx_l0,
                            *flat)
