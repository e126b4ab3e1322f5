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
drivers pick them, and its ``eps`` is the pair (eps0, eps); and the
``flow_posterior`` family of toy-maf (models/vae/maf.py): its ``eps`` is the
base Gaussian's draw z0, pushed through the flow's inverse, and its KLD the
one-sample Monte-Carlo log q(z|x) - log p(z).

``vae_loss(compute_dtype='bfloat16')`` is the JAX twin's mixed precision
(api.py:34-75): the encoder and decoder on bf16 copies of the fp32
parameters, the Gaussian sampling, a flow (on the fp32 parameters) and
the loss reductions in fp32; evaluation stays fp32.
"""

import torch

from ardae_tpu_torch.core.precision import cast_input, cast_module, fp32
from ardae_tpu_torch.core.losses import iwae_bound, loss_kld_gaussian, reduce_batch
from ardae_tpu_torch.core.rng import sample_gaussian
from ardae_tpu_torch.core.stats import logprob_gaussian
from ardae_tpu_torch.models.ivae import api as ivae_api
from ardae_tpu_torch.models.vae import aux

AUX = "aux_gaussian_posterior"
FLOW = "flow_posterior"


def _flow_sample(module, mu, logvar, ctx, generator, eps):
    """z = T^{-1}(z0; ctx) with z0 ~ N(mu, e^logvar) of mu's shape (..., z)
    (``eps``: z0's standard-normal draw) and ``ctx`` one row for each of
    mu's rows; returns (z, log q(z|x)), shaped as mu and as its rows."""
    z0 = sample_gaussian(mu, logvar, generator, eps)
    z, sum_a = module.flow_inverse(z0.reshape(-1, mu.shape[-1]), ctx)
    logq = (torch.sum(logprob_gaussian(mu, logvar, z0), dim=-1)
            - sum_a.reshape(mu.shape[:-1]))
    return z.reshape(mu.shape), logq


def vae_loss(module, x, beta=1.0, reduce="mean", generator=None, eps=None,
             compute_dtype=None):
    """mean(recon + beta * KLD), or the (bsz,) vector with
    ``reduce='per_item'``. ``eps``: the posterior draw, (bsz, z_dim); a flow
    model's KLD is log q(z|x) - log p(z) at that one draw (no closed form
    through the flow). ``compute_dtype``: as the module docstring says.
    Returns (loss, {"recon", "kld": batch means, "z"})."""
    if module.family == AUX:
        return aux.aux_vae_loss(module, x, beta, reduce, generator, eps,
                                compute_dtype)
    net, x_c = cast_module(module, compute_dtype), cast_input(x, compute_dtype)
    if module.family == FLOW:
        mu, logvar, ctx = fp32(net.encode_ctx(x_c))
        # the flow runs on the fp32 parameters
        z, logq = _flow_sample(module, mu, logvar, ctx, generator, eps)
        kld = logq - torch.sum(logprob_gaussian(0.0, 0.0, z), dim=-1)
    else:
        mu, logvar = fp32(net.encode_params(x_c))
        z = sample_gaussian(mu, logvar, generator, eps)
        kld = loss_kld_gaussian(mu, logvar, reduce="per_item")
    recon = ivae_api.recon_loss_fn(
        module, fp32(net.decode_params(z.to(x_c.dtype))), x)
    loss = reduce_batch(recon + beta * kld, reduce)
    return loss, {"recon": torch.mean(recon), "kld": torch.mean(kld), "z": z}


def generate(module, batch_size, generator=None, eps=None, u=None):
    """Prior samples: (x sample, x mean or probabilities, z); ``eps`` is z
    itself, (batch_size, z_dim)."""
    return ivae_api.generate(module, batch_size, generator, eps, u)


def reconstruct(module, x, generator=None, eps=None, u=None):
    """x -> z ~ q(z|x) -> x sample: (x sample, x mean or probabilities, z);
    an aux model draws z0, then z; a flow model pushes its base draw
    through the flow."""
    if module.family == AUX:
        z = aux.encode_sample(module, module.trunk_feats(x), generator, eps)[-1]
    elif module.family == FLOW:
        mu, logvar, ctx = module.encode_ctx(x)
        z = _flow_sample(module, mu, logvar, ctx, generator, eps)[0]
    else:
        mu, logvar = module.encode_params(x)
        z = sample_gaussian(mu, logvar, generator, eps)
    return (*ivae_api.decode_sample(module, z, generator, u), z)


def logprob_iwae(module, x, sample_size, reduce="mean", generator=None, eps=None):
    """IWAE bound with the exact q, per item or its mean (a flow model's q
    through its flow). ``eps``: the posterior (or base) draws, (bsz,
    sample_size, z_dim)."""
    if module.family == AUX:
        return aux.aux_logprob_iwae(module, x, sample_size, reduce, generator, eps)
    bsz = x.shape[0]
    if module.family == FLOW:
        mu_qz, logvar_qz, ctx = module.encode_ctx(x)
    else:
        mu_qz, logvar_qz = module.encode_params(x)
    zdim = mu_qz.shape[-1]
    mu = mu_qz[:, None, :].expand(bsz, sample_size, zdim)
    logvar = logvar_qz[:, None, :].expand(bsz, sample_size, zdim)
    if module.family == FLOW:
        ctx_rep = ctx[:, None, :].expand(bsz, sample_size, ctx.shape[-1])
        z, logposterior = _flow_sample(module, mu, logvar,
                                       ctx_rep.reshape(bsz * sample_size, -1),
                                       generator, eps)
    else:
        z = sample_gaussian(mu, logvar, generator, eps)
        logposterior = torch.sum(logprob_gaussian(mu, logvar, z), dim=-1)
    logprior = torch.sum(logprob_gaussian(0.0, 0.0, z), dim=-1)
    dist_params = module.decode_params(z.reshape(bsz * sample_size, zdim))
    loglikelihood = ivae_api.loglik(module, dist_params, x.reshape(bsz, 1, -1),
                                    (bsz, sample_size))
    logw = loglikelihood + logprior - logposterior
    return reduce_batch(iwae_bound(logw, dim=1), reduce)
