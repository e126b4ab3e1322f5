"""Functional API of the implicit-posterior VAEs (JAX twin:
ardae_tpu/models/ivae/api.py): sampling, the training loss, generation and
reconstruction, and the IWS bound with a covariance-Gaussian
pseudo-posterior, each for a Bernoulli (``logit``) or a Gaussian (``mu,
logvar``) likelihood. The KDE, diagonal and prior bounds wait (ROADMAP
queue 1, slice 6).

Every sampler takes an optional injected noise tensor (``eps=``, ``u=``)
and otherwise draws from an explicit ``torch.Generator``; z always comes
back (bsz, nz, z_dim). A flat model's encoder noise is one tensor
(bsz*nz, noise_dim), scaled here by ``noise_std``; a hierarchical one's
(``family == "aux"``, models/ivae/aux.py) is the pair (eps0 (bsz*nz,
noise_dim), eps (bsz*nz, z_dim)), which the model scales itself.
"""

import torch

from ardae_tpu_torch.core.energy import normal_energy_func
from ardae_tpu_torch.core.losses import (
    iwae_bound,
    loss_recon_bernoulli_with_logit,
    loss_recon_gaussian,
    reduce_batch,
)
from ardae_tpu_torch.core.rng import sample_gaussian
from ardae_tpu_torch.core.stats import covmat, logprob_gaussian, mvn_logprob


def make_eps(module, bsz, nz, noise_std=None, generator=None, eps=None,
             device=None):
    """The encoder's noise inputs: (bsz*nz, noise_dim) scaled by noise_std,
    or an aux model's unscaled pair (eps0, eps), eps0 drawn first."""
    aux = module.family == "aux"
    if eps is None:
        if generator is None:
            raise ValueError("make_eps needs a generator or an injected eps")
        dev = device if device is not None else generator.device
        widths = (module.noise_dim, module.z_dim) if aux else (module.noise_dim,)
        draws = tuple(torch.randn((bsz * nz, w), generator=generator, device=dev)
                      for w in widths)
        eps = draws if aux else draws[0]
    if aux:
        return tuple(eps)
    return (1.0 if noise_std is None else noise_std) * eps


def sample_latents(module, x, nz, noise_std=None, generator=None, eps=None):
    """forward_hidden: z ~ q(z|x), (bsz, nz, z_dim)."""
    eps = make_eps(module, x.shape[0], nz, noise_std, generator, eps,
                   device=x.device)
    if module.family == "aux":
        return module.sample_z(x, tuple(e.to(x.dtype) for e in eps), noise_std)
    return module.sample_z(x, eps.to(x.dtype))


def _zero_eps(module, x):
    zeros = lambda w: torch.zeros((x.shape[0], w), dtype=x.dtype, device=x.device)
    if module.family == "aux":
        return (zeros(module.noise_dim), zeros(module.z_dim))
    return zeros(module.noise_dim)


def encode_det(module, x):
    """encode(x, std=0): deterministic latent, (bsz, 1, z_dim); an aux
    model takes the noise scale 0.0 (None would mean 1)."""
    if module.family == "aux":
        return module.sample_z(x, _zero_eps(module, x), 0.0)
    return module.sample_z(x, _zero_eps(module, x))


def encode_hidden_feats(module, x):
    """The hidden1a context at std 0, (bsz, context width): aux models only
    (the reference crashes for a flat model too: ivae_ardae.py:738 calls a
    method that only the aux encoders define)."""
    if module.family != "aux":
        raise NotImplementedError("hidden1a context requires an aux model")
    return module.hidden_feats(x, _zero_eps(module, x), 0.0)


def recon_loss_fn(module, dist_params, target_flat):
    """Per-row negative log-likelihood of ``target_flat`` under the decoder's
    ``dist_params``."""
    if module.likelihood == "bernoulli":
        (logit,) = dist_params
        return loss_recon_bernoulli_with_logit(
            logit, target_flat.reshape(logit.shape[0], -1), reduce="per_item")
    mu, logvar = dist_params
    return loss_recon_gaussian(
        mu, logvar, target_flat.reshape(mu.shape[0], -1), reduce="per_item")


def ivae_loss(module, x, nz, beta=1.0, noise_std=None, generator=None,
              eps=None):
    """loss = mean(recon + beta * prior_energy); the q-entropy term is absent
    on purpose (its gradient is injected by the CDAE, train/step.py).
    Returns (loss, dict of terms)."""
    bsz = x.shape[0]
    z = sample_latents(module, x, nz, noise_std, generator, eps)
    z_flat = z.reshape(bsz * nz, -1)
    dist_params = module.decode_params(z_flat)
    x_flat = x.reshape(bsz, -1)
    target = x_flat[:, None, :].expand(bsz, nz, x_flat.shape[-1])
    recon = recon_loss_fn(module, dist_params, target.reshape(bsz * nz, -1))
    prior = normal_energy_func(z_flat)
    loss = torch.mean(recon + beta * prior)
    return loss, {"z": z, "recon": torch.mean(recon),
                  "prior": torch.mean(prior), "dist_params": dist_params}


def decode_sample(module, z, generator=None, u=None):
    """(x sample, x mean or probabilities) of the decoder at z (bsz, z_dim):
    a Bernoulli sample ``u < p`` (``u`` uniform) or a Gaussian one ``mu +
    exp(logvar / 2) u`` (``u`` standard normal), ``u`` drawn from
    ``generator`` when not given."""
    dist_params = module.decode_params(z)
    if module.likelihood == "bernoulli":
        (logit,) = dist_params
        probs = torch.sigmoid(logit)
        if u is None:
            if generator is None:
                raise ValueError("the decoder sample needs a generator or an "
                                 "injected u")
            u = torch.rand(probs.shape, generator=generator,
                           device=generator.device)
        return (u.to(probs.device) < probs).to(torch.float32), probs
    mu, logvar = dist_params
    return sample_gaussian(mu, logvar, generator, u), mu


def generate(module, batch_size, generator=None, eps=None, u=None):
    """z ~ N(0, I), decoded and sampled (reference models/ivae/mnist.py:
    303-316): (x sample, x mean or probabilities, z). ``eps`` is z itself,
    (batch_size, z_dim); ``u`` the decoder sample's noise."""
    device = next(module.parameters()).device
    if eps is None:
        if generator is None:
            raise ValueError("generate needs a generator or an injected eps")
        eps = torch.randn((batch_size, module.z_dim), generator=generator,
                          device=generator.device)
    z = eps.to(device=device, dtype=torch.float32)
    return (*decode_sample(module, z, generator, u), z)


def reconstruct(module, x, generator=None, eps=None, u=None):
    """x -> one z ~ q(z|x) -> x sample: (x sample, x mean or probabilities,
    z (bsz, z_dim)). ``eps``: the encoder's noise (bsz, noise_dim), or an
    aux model's pair; ``u`` the decoder sample's noise."""
    z = sample_latents(module, x, 1, generator=generator, eps=eps)
    z_flat = z.reshape(x.shape[0], -1)
    return (*decode_sample(module, z_flat, generator, u), z_flat)


def logprob_iws(module, x, sample_size, jitter=0.0, noise_std=None,
                reduce="mean", generator=None, eps=None, new_eps=None):
    """IWS log-likelihood with a covariance-Gaussian pseudo-posterior
    (reference models/ivae/mnist.py:378-437): every item's implicit draws
    fit N(mu, cov), which is re-sampled and importance-weighted, the batch
    in one Cholesky, one triangular solve and one decode. Needs
    sample_size >= 2*z_dim for a full-rank covariance. ``eps`` is the
    encoder's noise (bsz*ssz, noise_dim; an aux model's pair) and
    ``new_eps`` the re-sample noise (bsz, ssz, z_dim); each is drawn from
    ``generator`` when not given, the encoder's first. The aux models are
    evaluated with ``jitter`` 1e-5 (reference models/ivae/auxmnist.py:
    297-357)."""
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
    bsz, ssz, zdim = newz.shape
    logprior = torch.sum(logprob_gaussian(0.0, 0.0, newz), dim=-1)
    dist_params = module.decode_params(newz.reshape(bsz * ssz, zdim))
    return loglik(module, dist_params, x.reshape(bsz, 1, -1), (bsz, ssz)), logprior


def loglik(module, dist_params, target, lead):
    """log p(target | z) summed over the features, shaped ``lead``: the
    decoder's flat ``dist_params`` reshaped to (*lead, D) against ``target``
    (broadcast to it)."""
    dist_params = [p.reshape(*lead, -1) for p in dist_params]
    if module.likelihood == "bernoulli":
        (logit,) = dist_params
        return -torch.sum(loss_recon_bernoulli_with_logit(
            logit, target, reduce="none"), dim=-1)
    mu, logvar = dist_params
    return torch.sum(logprob_gaussian(mu, logvar, target), dim=-1)
