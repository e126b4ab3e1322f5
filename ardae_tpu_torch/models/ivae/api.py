"""Functional API of the implicit-posterior VAEs (JAX twin:
ardae_tpu/models/ivae/api.py). The IWS evaluators wait (ROADMAP queue 1).

Every sampler takes an optional injected noise tensor (``eps=``) and
otherwise draws from an explicit ``torch.Generator``; z always comes back
(bsz, nz, z_dim).
"""

import torch

from ardae_tpu_torch.core.energy import normal_energy_func
from ardae_tpu_torch.core.losses import loss_recon_bernoulli_with_logit


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
