"""Finite-difference Jacobian-clamping penalty (Odena et al. 2018; JAX
twin: ardae_tpu/core/jacobian_clamping.py; reference
utils/jacobian_clamping.py:9-114).

loss = mean(minrelu(|f(z + EPS u) - f(z)|^2 / (EPS^2 |u|^2) - eta_min)^2)
penalises the directional squared Jacobian norms of a sampler f that fall
below eta_min. The perturbation u ~ N(0, I) is injected (``perturb``) or
drawn from ``generator``. Neither driver takes the ``--lmbd-*`` flags that
would weigh it in, as the JAX driver does not (the reference's models
leave it raising).
"""

import torch


def minrelu(x):
    """min(x, 0) (reference :9-10)."""
    return -torch.relu(-x)


def _perturbation(shape, generator, perturb, like):
    if perturb is None:
        if generator is None:
            raise ValueError("needs a generator or an injected perturb")
        return torch.randn(shape, generator=generator, device=generator.device,
                           dtype=like.dtype).to(like.device)
    return perturb.to(device=like.device, dtype=like.dtype).reshape(shape)


def _penalty(x_diff, perturb, eps, eta_min):
    numel = x_diff.shape[0]
    unjac_l2sq = torch.sum(x_diff.reshape(numel, -1) ** 2, dim=1) / (eps ** 2)
    per_l2sq = torch.sum(perturb.reshape(numel, -1) ** 2, dim=1)
    return torch.mean(minrelu(unjac_l2sq / per_l2sq - eta_min) ** 2)


def jac_clamping_loss(forward, x, z, num_pert_samples, eta_min, eps=0.01,
                      postprocessing=None, generator=None, perturb=None):
    """Unconditional variant (reference :12-62): ``forward`` maps z rows to
    x rows; x (bsz, x_dim) = forward(z), z (bsz, z_dim); ``perturb``
    (bsz, num_pert_samples, z_dim)."""
    bsz, zdim = z.shape
    numel = bsz * num_pert_samples
    perturb = _perturbation((bsz, num_pert_samples, zdim), generator, perturb, z)
    z_bar = (z[:, None, :] + eps * perturb).reshape(numel, zdim)
    x_rep = x[:, None, :].expand(bsz, num_pert_samples, x.shape[-1]).reshape(numel, -1)
    x_bar = forward(z_bar)
    if postprocessing is not None:
        x_rep, x_bar = postprocessing(x_rep), postprocessing(x_bar)
    return _penalty(x_bar - x_rep, perturb, eps, eta_min)


def cond_jac_clamping_loss(forward, x, ctx, z, num_z_samples, num_pert_samples,
                           eta_min, eps=0.01, postprocessing=None,
                           generator=None, perturb=None):
    """Conditional variant (reference :64-114): ``forward(ctx, z_rows,
    num_z_samples, num_pert_samples)`` maps z rows to x rows; x, z
    (bsz * num_z_samples, dim), ctx (bsz, ctx_dim); ``perturb``
    (bsz * num_z_samples, num_pert_samples, z_dim)."""
    rows = ctx.shape[0] * num_z_samples
    zdim = z.shape[-1]
    numel = rows * num_pert_samples
    perturb = _perturbation((rows, num_pert_samples, zdim), generator, perturb, z)
    z_bar = (z[:, None, :] + eps * perturb).reshape(numel, zdim)
    x_rep = x[:, None, :].expand(rows, num_pert_samples, x.shape[-1]).reshape(numel, -1)
    x_bar = forward(ctx, z_bar, num_z_samples, num_pert_samples)
    if postprocessing is not None:
        x_rep, x_bar = postprocessing(x_rep), postprocessing(x_bar)
    return _penalty(x_bar - x_rep, perturb, eps, eta_min)
