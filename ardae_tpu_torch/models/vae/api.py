"""Functional API of the Gaussian-posterior baseline VAEs (JAX twin:
ardae_tpu/models/vae/api.py): the ELBO loss (reference
models/vae/mnist.py:131-160), the IWAE bound with the exact Gaussian q
(reference :179-220), generation and reconstruction.

Every function takes its noise injected (``eps=`` for the posterior or prior
draw, ``u=`` for the decoder's sample) or draws it from an explicit
``torch.Generator``. The ``gaussian_posterior`` family is ported, with a
Bernoulli or a Gaussian likelihood (the decoder sample and the likelihood
are the implicit models', models/ivae/api.py), and the hierarchical
``aux_gaussian_posterior`` one: ``vae_loss`` and ``logprob_iwae`` hand it to
``aux_vae_loss`` / ``aux_logprob_iwae`` (models/vae/aux.py), as the JAX
drivers pick them, and its ``eps`` is the pair (eps0, eps); the flow
family raises naming its ROADMAP item.
"""

import torch

from ardae_tpu_torch.core.losses import iwae_bound, loss_kld_gaussian, reduce_batch
from ardae_tpu_torch.core.rng import sample_gaussian
from ardae_tpu_torch.core.stats import logprob_gaussian
from ardae_tpu_torch.models.ivae import api as ivae_api
from ardae_tpu_torch.models.vae import aux

AUX = "aux_gaussian_posterior"
_LATER = {"flow_posterior": "slice 6 (item 14, the MAF posterior of toy-maf)"}


def _check(module):
    if module.family in _LATER:
        raise NotImplementedError(
            f"the {module.family} family is not ported yet: ROADMAP queue 1, "
            + _LATER[module.family])


def vae_loss(module, x, beta=1.0, reduce="mean", generator=None, eps=None):
    """mean(recon + beta * KLD), or the (bsz,) vector with
    ``reduce='per_item'``. ``eps``: the posterior draw, (bsz, z_dim).
    Returns (loss, {"recon", "kld": batch means, "z"})."""
    _check(module)
    if module.family == AUX:
        return aux.aux_vae_loss(module, x, beta, reduce, generator, eps)
    mu, logvar = module.encode_params(x)
    z = sample_gaussian(mu, logvar, generator, eps)
    kld = loss_kld_gaussian(mu, logvar, reduce="per_item")
    recon = ivae_api.recon_loss_fn(module, module.decode_params(z), x)
    loss = reduce_batch(recon + beta * kld, reduce)
    return loss, {"recon": torch.mean(recon), "kld": torch.mean(kld), "z": z}


def generate(module, batch_size, generator=None, eps=None, u=None):
    """Prior samples: (x sample, x mean or probabilities, z); ``eps`` is z
    itself, (batch_size, z_dim)."""
    _check(module)
    return ivae_api.generate(module, batch_size, generator, eps, u)


def reconstruct(module, x, generator=None, eps=None, u=None):
    """x -> z ~ q(z|x) -> x sample: (x sample, x mean or probabilities, z);
    an aux model draws z0, then z."""
    _check(module)
    if module.family == AUX:
        z = aux.encode_sample(module, module.trunk_feats(x), generator, eps)[-1]
    else:
        mu, logvar = module.encode_params(x)
        z = sample_gaussian(mu, logvar, generator, eps)
    return (*ivae_api.decode_sample(module, z, generator, u), z)


def logprob_iwae(module, x, sample_size, reduce="mean", generator=None, eps=None):
    """IWAE bound with the exact Gaussian q, per item or its mean. ``eps``:
    the posterior draws, (bsz, sample_size, z_dim)."""
    _check(module)
    if module.family == AUX:
        return aux.aux_logprob_iwae(module, x, sample_size, reduce, generator, eps)
    bsz = x.shape[0]
    mu_qz, logvar_qz = module.encode_params(x)
    zdim = mu_qz.shape[-1]
    mu = mu_qz[:, None, :].expand(bsz, sample_size, zdim)
    logvar = logvar_qz[:, None, :].expand(bsz, sample_size, zdim)
    z = sample_gaussian(mu, logvar, generator, eps)
    logposterior = torch.sum(logprob_gaussian(mu, logvar, z), dim=-1)
    logprior = torch.sum(logprob_gaussian(0.0, 0.0, z), dim=-1)
    dist_params = module.decode_params(z.reshape(bsz * sample_size, zdim))
    loglikelihood = ivae_api.loglik(module, dist_params, x.reshape(bsz, 1, -1),
                                    (bsz, sample_size))
    logw = loglikelihood + logprior - logposterior
    return reduce_batch(iwae_bound(logw, dim=1), reduce)
