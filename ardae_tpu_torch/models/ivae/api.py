"""Functional API of the implicit-posterior VAEs (JAX twin:
ardae_tpu/models/ivae/api.py): sampling, the training loss and the IWS
bound with a covariance-Gaussian pseudo-posterior. The KDE, diagonal and
prior bounds wait (ROADMAP queue 1, slice 6).

Every sampler takes an optional injected noise tensor (``eps=``) and
otherwise draws from an explicit ``torch.Generator``; z always comes back
(bsz, nz, z_dim).
"""

import torch

from ardae_tpu_torch.core.energy import normal_energy_func
from ardae_tpu_torch.core.losses import (
    iwae_bound,
    loss_recon_bernoulli_with_logit,
    reduce_batch,
)
from ardae_tpu_torch.core.stats import covmat, logprob_gaussian, mvn_logprob


def make_eps(module, bsz, nz, noise_std=None, generator=None, eps=None,
             device=None):
    """The encoder's noise inputs, (bsz*nz, noise_dim), scaled by noise_std."""
    scale = 1.0 if noise_std is None else noise_std
    if eps is None:
        if generator is None:
            raise ValueError("make_eps needs a generator or an injected eps")
        eps = torch.randn((bsz * nz, module.noise_dim), generator=generator,
                          device=device if device is not None else generator.device)
    return scale * eps


def sample_latents(module, x, nz, noise_std=None, generator=None, eps=None):
    """forward_hidden: z ~ q(z|x), (bsz, nz, z_dim)."""
    eps = make_eps(module, x.shape[0], nz, noise_std, generator, eps,
                   device=x.device)
    return module.sample_z(x, eps.to(x.dtype))


def encode_det(module, x):
    """encode(x, std=0): deterministic latent, (bsz, 1, z_dim)."""
    eps = torch.zeros((x.shape[0], module.noise_dim), dtype=x.dtype,
                      device=x.device)
    return module.sample_z(x, eps)


def ivae_loss(module, x, nz, beta=1.0, noise_std=None, generator=None,
              eps=None):
    """loss = mean(recon + beta * prior_energy); the q-entropy term is absent
    on purpose (its gradient is injected by the CDAE, train/step.py).
    Returns (loss, dict of terms)."""
    bsz = x.shape[0]
    z = sample_latents(module, x, nz, noise_std, generator, eps)
    z_flat = z.reshape(bsz * nz, -1)
    (logit,) = module.decode_params(z_flat)
    x_flat = x.reshape(bsz, -1)
    target = x_flat[:, None, :].expand(bsz, nz, x_flat.shape[-1])
    recon = loss_recon_bernoulli_with_logit(
        logit, target.reshape(bsz * nz, -1), reduce="per_item")
    prior = normal_energy_func(z_flat)
    loss = torch.mean(recon + beta * prior)
    return loss, {"z": z, "recon": torch.mean(recon),
                  "prior": torch.mean(prior), "dist_params": (logit,)}


def logprob_iws(module, x, sample_size, jitter=0.0, noise_std=None,
                reduce="mean", generator=None, eps=None, new_eps=None):
    """IWS log-likelihood with a covariance-Gaussian pseudo-posterior
    (reference models/ivae/mnist.py:378-437): every item's implicit draws
    fit N(mu, cov), which is re-sampled and importance-weighted, the batch
    in one Cholesky, one triangular solve and one decode. Needs
    sample_size >= 2*z_dim for a full-rank covariance. ``eps`` is the
    encoder's noise (bsz*ssz, noise_dim) and ``new_eps`` the re-sample
    noise (bsz, ssz, z_dim); each is drawn from ``generator`` when not
    given, the encoder's first."""
    z = sample_latents(module, x, sample_size, noise_std, generator, eps)
    per_item = cov_gaussian_iws_from_draws(module, x, z, jitter, generator,
                                           new_eps)
    return reduce_batch(per_item, reduce)


def cov_gaussian_iws_from_draws(module, x, z, jitter=0.0, generator=None,
                                eps=None):
    """The cov-Gaussian bound given posterior draws z (bsz, ssz, zdim): fit,
    re-sample with ``eps`` (bsz, ssz, zdim; drawn from ``generator`` when
    not given), importance-weight. Returns the per-item (bsz,) bound."""
    bsz, ssz, zdim = z.shape
    mu_qz = torch.mean(z, dim=1)
    eye = torch.eye(zdim, dtype=z.dtype, device=z.device)
    cov = covmat(z) + jitter * eye
    # relative floor: an early or collapsed posterior makes the sample
    # covariance rank-deficient, where a raw Cholesky fails; 1e-6 x the mean
    # diagonal is far below the 0.2-nat comparability budget
    mean_diag = torch.mean(torch.diagonal(cov, dim1=-2, dim2=-1), dim=-1)
    cov = cov + (1e-6 * mean_diag + 1e-30)[:, None, None] * eye
    chol = torch.linalg.cholesky(cov)

    if eps is None:
        if generator is None:
            raise ValueError("the IWS re-sample needs a generator or an "
                             "injected eps")
        eps = torch.randn((bsz, ssz, zdim), generator=generator,
                          device=generator.device)
    eps = eps.to(device=z.device, dtype=z.dtype)
    newz = mu_qz[:, None, :] + torch.matmul(eps, chol.transpose(-1, -2))
    logposterior = mvn_logprob(newz, mu_qz, chol)
    loglikelihood, logprior = _loglik_and_prior(module, x, newz)
    return iwae_bound(loglikelihood + logprior - logposterior, dim=1)


def _loglik_and_prior(module, x, newz):
    """log p(x|z) + log p(z) terms, each (bsz, ssz)."""
    if module.likelihood != "bernoulli":
        raise NotImplementedError(
            "Gaussian likelihoods are not ported yet: ROADMAP queue 1, "
            "slice 3 (item 11, the Normal head)")
    bsz, ssz, zdim = newz.shape
    logprior = torch.sum(logprob_gaussian(0.0, 0.0, newz), dim=-1)
    (logit,) = module.decode_params(newz.reshape(bsz * ssz, zdim))
    neg_ll = loss_recon_bernoulli_with_logit(
        logit.reshape(bsz, ssz, -1), x.reshape(bsz, 1, -1), reduce="none")
    return -torch.sum(neg_ll, dim=-1), logprior
