"""Reparameterised sampling (JAX twin: ardae_tpu/core/rng.py).

Every sampler takes an injected noise tensor (``eps=``) or draws it from an
explicit ``torch.Generator``; nothing reads the global RNG. Laplace noise
waits (ROADMAP queue 1, slice 4).
"""

import torch


def sample_gaussian(mu, logvar, generator=None, eps=None):
    """mu + exp(logvar / 2) * eps, eps ~ N(0, I) of mu's shape (reference
    models/reparam.py:42-51)."""
    if eps is None:
        if generator is None:
            raise ValueError("sample_gaussian needs a generator or an injected eps")
        eps = torch.randn(mu.shape, generator=generator, device=generator.device,
                          dtype=mu.dtype)
    eps = eps.to(device=mu.device, dtype=mu.dtype).reshape(mu.shape)
    return mu + torch.exp(0.5 * logvar) * eps
