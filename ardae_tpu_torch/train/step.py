"""The joint AR-DAE training step (JAX twin: ardae_tpu/train/step.py).

  PHASE A (x num_cdae_updates, each on its own data batch):
    sigma_i   = delta * mean_d std_s( std_scale * (z_s - z_det) )   per item
    stdmat    ~ sigma_i * N(0,1)  per (item, sample)
    cdae loss = mse(sigma * score(x_bar, ctx, sigma), -eps)
    cdae optimizer step.
  PHASE B (fresh batch):
    model loss = mean(recon + beta * prior_energy), plus the entropy-gradient
    surrogate beta/(bsz*nz) * sum(stop_grad(score) * std_scale*(z - z_det)),
    whose d/dz is the gradient the reference injects by graph surgery.
    model optimizer step.

PyTorch runs eagerly: the K-step chunk is a Python loop over steps, with the
batch gather and the Bernoulli binarization on the device. Every random draw
can be injected (``draws``); otherwise it comes from the explicit generator.
After each step, ``update_weight_avg`` moves the averaged model (Polyak or
SWA) in a few ``torch._foreach_*`` passes.

Mixed precision follows the JAX twin (step.py:41-85, :114-264):
``cdae_compute_dtype='bfloat16'`` runs phase A's sampling pass, its
hidden1a context and the DSM loss's score net on bf16 copies of the fp32
parameters, the sigma statistics and the loss product in fp32;
``model_compute_dtype='bfloat16'`` runs phase B's model loss and its
detached context and latent-mean passes so, cast back to fp32. The fused
kernels are fp32 only: ``--use-kernels`` with a bf16 phase A raises.
"""

import dataclasses

import torch

from ardae_tpu_torch.core.precision import cast_input, cast_module, compute_dtype
from ardae_tpu_torch.data.loader import gather_batches
from ardae_tpu_torch.models.cdae.cardae import cdae_loss, cdae_score
from ardae_tpu_torch.models.ivae import api as ivae_api
from ardae_tpu_torch.ops.fused_dsm import fused_cdae_dsm_loss, supports_fused_dsm
from ardae_tpu_torch.ops.fused_dsm_grad import (
    fused_cdae_dsm_grad_loss,
    supports_fused_dsm_grad,
)

# --use-kernels: each cdae style's hand-written kernel and the guard that
# decides whether it covers a cdae
_KERNELS = {"res": (supports_fused_dsm, fused_cdae_dsm_loss),
            "grad": (supports_fused_dsm_grad, fused_cdae_dsm_grad_loss)}


@dataclasses.dataclass(frozen=True)
class StepConfig:
    std_scale: float = 1.0
    delta: float = 1.0
    num_cdae_updates: int = 1
    train_nz_cdae: int = 1
    train_nstd_cdae: int = 1
    train_nz_model: int = 1
    ctx_type: str = "data"  # data | lt0 | hidden1a (aux models)
    # the hand-written fused DSM kernels for phase A (ops/fused_dsm for a
    # res-style cdae, ops/fused_dsm_grad for a grad-style one); a config the
    # kernel does not cover raises instead of falling back
    use_kernels: bool = False
    # mixed precision ("float32" | "bfloat16"): phase A's sampling pass,
    # hidden1a context and score net; phase B's model loss and detached
    # passes (the JAX twin's fields of the same names)
    cdae_compute_dtype: str = "float32"
    model_compute_dtype: str = "float32"
    weight_avg: str = "none"  # none | polyak | swa
    weight_avg_start: int = 1000
    weight_avg_decay: float = 0.998


def _randn(shape, generator, device, injected=None):
    if injected is not None:
        return injected.to(device=device, dtype=torch.float32).reshape(shape)
    return torch.randn(shape, generator=generator, device=device)


def compute_context(model, x, ctx_type):
    """CDAE conditioning (reference ivae_ardae.py:729-741), detached."""
    with torch.no_grad():
        if ctx_type == "data":
            ctx = x.reshape(x.shape[0], -1)
            return 2.0 * ctx - 1.0 if model.center_input else ctx
        if ctx_type == "lt0":
            z = ivae_api.encode_det(model, x)
            return z.reshape(z.shape[0], -1)
        if ctx_type == "hidden1a":
            return ivae_api.encode_hidden_feats(model, x)
    raise NotImplementedError(ctx_type)


@torch.no_grad()
def _sigma_stats(model, x, cfg, generator, latent_eps=None):
    """Per-item adaptive noise level (reference ivae_ardae.py:748-758). The
    sampling pass runs in phase A's compute dtype, the statistics in fp32;
    also returns that pass's model and input, for the hidden1a context."""
    net = cast_module(model, cfg.cdae_compute_dtype)
    x_c = cast_input(x, cfg.cdae_compute_dtype)
    latent_mean = ivae_api.encode_det(net, x_c).float()             # (B,1,z)
    latent = ivae_api.sample_latents(net, x_c, cfg.train_nz_cdae,
                                     generator=generator, eps=latent_eps).float()
    lsm = cfg.std_scale * (latent - latent_mean)                    # (B,nz,z)
    std_qz = torch.std(lsm, dim=1, keepdim=True, unbiased=True)     # (B,1,z)
    sigma = cfg.delta * torch.mean(std_qz, dim=2, keepdim=True)     # (B,1,1)
    return lsm, sigma, latent_mean, net, x_c


def _phase_a_kernel(cdae, n_rows, dtype):
    """The fused DSM loss of ``cdae``'s style, or raise naming the reason:
    a bf16 phase A, or the guard that refused the cdae."""
    if compute_dtype(dtype) is not None:
        raise NotImplementedError(
            "--use-kernels with a bf16 phase A (--cdae-compute-dtype "
            "bfloat16): the fused DSM kernels compute in fp32 only, and the "
            "JAX twin never dispatches its fused kernel in a bf16 phase A "
            "(ardae_tpu/train/step.py:186-192, \"the fused path is "
            "fp32-only\"; it runs XLA there); the port keeps no fallback "
            "that hides a kernel: drop --use-kernels, or run phase A in fp32")
    guard, loss_fn = _KERNELS[cdae.score_type]
    if not guard(cdae, n_rows):
        raise NotImplementedError(
            f"--use-kernels: {guard.__module__}.{guard.__name__} refused this "
            f"{cdae.score_type}-style cdae ({cdae.nonlinearity}, h {cdae.h_dim}, "
            f"{n_rows} rows); the kernel covers the conditional, "
            "sigma-conditioned, enc_input CARDAE with softplus/relu/tanh in "
            "fp32 within its workspace cap")
    return loss_fn


def cdae_update(model, cdae, opt_d, cfg, x, generator, draws=None):
    """One PHASE-A update, in place. ``draws``: optional injected
    ``latent_eps`` (B*nz, noise; an aux model's pair), ``std`` (B, nz*nstd,
    1), ``dsm_eps`` (B*nz*nstd, z). Returns the metrics (detached
    tensors)."""
    draws = draws or {}
    bsz = x.shape[0]
    lsm, sigma, latent_mean, net, x_c = _sigma_stats(
        model, x, cfg, generator, draws.get("latent_eps"))
    if cfg.ctx_type == "lt0":
        # the std=0 encoding doubles as the context (ivae_ardae.py:735+748)
        ctx = latent_mean.reshape(bsz, -1)
    elif cfg.ctx_type == "hidden1a":
        # the std=0 features of the sigma pass's parameters and input, in
        # its dtype, then fp32 (JAX step.py:157-160)
        ctx = compute_context(net, x_c, cfg.ctx_type).float()
    else:
        ctx = compute_context(model, x, cfg.ctx_type)
    ns = cfg.train_nz_cdae * cfg.train_nstd_cdae
    stdmat = sigma * _randn((bsz, ns, 1), generator, x.device, draws.get("std"))
    zdim = lsm.shape[-1]
    lsm_exp = lsm if cfg.train_nstd_cdae == 1 else (
        lsm[:, :, None, :].expand(bsz, cfg.train_nz_cdae, cfg.train_nstd_cdae,
                                  zdim).reshape(bsz, ns, zdim))
    noise = dict(generator=generator, eps=draws.get("dsm_eps"))
    if cfg.use_kernels:
        loss_fn = _phase_a_kernel(cdae, bsz * ns, cfg.cdae_compute_dtype)
        loss = loss_fn(cdae, lsm_exp, ctx, stdmat, **noise)
    else:
        loss = cdae_loss(cdae, lsm_exp, ctx, stdmat,
                         compute_dtype=cfg.cdae_compute_dtype, **noise)
    opt_d.zero_grad(set_to_none=True)
    loss.backward()
    opt_d.step()
    return {"cdae_loss": loss.detach(), "std_eff_mean": sigma.mean(),
            "std_eff_max": sigma.max(), "std_eff_min": sigma.min()}


def model_update(model, cdae, opt_m, cfg, x, beta, generator, draws=None):
    """PHASE B, in place: ELBO-without-entropy + injected entropy gradient.
    ``draws``: optional injected ``eps`` (B*nz, noise_dim; an aux model's
    pair)."""
    draws = draws or {}
    bsz, nz = x.shape[0], cfg.train_nz_model
    model_loss, terms = ivae_api.ivae_loss(
        model, x, nz, beta=beta, generator=generator, eps=draws.get("eps"),
        compute_dtype=cfg.model_compute_dtype)
    z = terms["z"]
    with torch.no_grad():
        # the detached passes in phase B's dtype, then fp32 (JAX
        # step.py:238-251)
        net = cast_module(model, cfg.model_compute_dtype)
        x_det = cast_input(x, cfg.model_compute_dtype)
        latent_mean = ivae_api.encode_det(net, x_det).float()
        ctx = (latent_mean.reshape(bsz, -1) if cfg.ctx_type == "lt0"
               else compute_context(net, x_det, cfg.ctx_type).float())
        score = cdae_score(cdae, cfg.std_scale * (z - latent_mean), ctx, 0.0)
    aux = torch.sum(score * (cfg.std_scale * (z - latent_mean)))
    total = model_loss + beta * aux / (bsz * nz)
    opt_m.zero_grad(set_to_none=True)
    total.backward()
    opt_m.step()
    return {"model_loss": model_loss.detach(), "recon_loss": terms["recon"].detach(),
            "prior_loss": terms["prior"].detach()}


def one_step(state, cfg, cdae_batches, model_batch, beta, generator, draws=None):
    """One joint step on (U, B, D) phase-A batches and a (B, D) phase-B batch.
    ``draws``: optional {"cdae": [per-update draws], "model": draws}."""
    draws = draws or {}
    metrics = {}
    for i in range(cfg.num_cdae_updates):
        cd = draws.get("cdae")
        metrics.update(cdae_update(state.model, state.cdae, state.opt_cdae, cfg,
                                   cdae_batches[i], generator,
                                   cd[i] if cd else None))
    metrics.update(model_update(state.model, state.cdae, state.opt_model, cfg,
                                model_batch, beta, generator, draws.get("model")))
    state.step += 1
    update_weight_avg(state, cfg)
    return metrics


@torch.no_grad()
def update_weight_avg(state, cfg):
    """The averaged model after a step (JAX: ``_update_weight_avg``,
    reference ivae_ardae.py:559-565 via torchcontrib), in place, a few
    ``torch._foreach_*`` passes over every parameter at once. Averaging has
    started once the step just counted reaches ``cfg.weight_avg_start``;
    before that the average is the live model. Polyak: avg = d * avg + (1 -
    d) * p, in JAX's order of operations; SWA: the running mean avg += (p -
    avg) / count over the iterates since the start. No-op without an
    averaging slot."""
    if cfg.weight_avg == "none" or state.avg_model is None:
        return
    avg = list(state.avg_model.parameters())
    live = [p.detach() for p in state.model.parameters()]
    if state.step < cfg.weight_avg_start:
        torch._foreach_copy_(avg, live)
        return
    state.avg_count += 1
    if cfg.weight_avg == "polyak":
        d = cfg.weight_avg_decay
        part = torch._foreach_mul(live, 1.0 - d)
        torch._foreach_mul_(avg, d)
        torch._foreach_add_(avg, part)
    elif cfg.weight_avg == "swa":
        diff = torch._foreach_sub(live, avg)
        torch._foreach_div_(diff, float(state.avg_count))
        torch._foreach_add_(avg, diff)
    else:
        raise ValueError(f"unknown weight averaging {cfg.weight_avg!r}")


def train_chunk(state, cfg, data, cdae_idx, model_idx, generator, beta_fn,
                binarize=False, draws=None):
    """K joint steps: the Python-loop counterpart of the JAX lax.scan chunk.

    data: (N, D) on the device; cdae_idx (K, U, B) and model_idx (K, B)
    integer indices. ``draws``: optional per-step list of {"bin_cdae": (U, B,
    D) and "bin_model": (B, D) uniforms, "step": one_step's draws}. Returns
    the last step's metrics."""
    metrics = None
    for k in range(len(model_idx)):
        d = draws[k] if draws else {}
        c_idx = torch.as_tensor(cdae_idx[k], device=data.device)
        m_idx = torch.as_tensor(model_idx[k], device=data.device)
        cdae_batches = gather_batches(data, c_idx, binarize, generator,
                                      d.get("bin_cdae"))
        model_batch = gather_batches(data, m_idx, binarize, generator,
                                     d.get("bin_model"))
        metrics = one_step(state, cfg, cdae_batches, model_batch,
                           beta_fn(state.step), generator, d.get("step"))
    return metrics
