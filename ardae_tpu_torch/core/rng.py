"""Reparameterised sampling (JAX twin: ardae_tpu/core/rng.py).

Every sampler takes an injected noise tensor (``eps=``, ``u=``) or draws it
from an explicit ``torch.Generator``; nothing reads the global RNG.
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


def sample_laplace(shape, generator=None, u=None, dtype=torch.float32,
                   loc=0.0, scale=1.0, device=None):
    """Laplace noise by the inverse CDF (reference utils/sample.py:3-12):
    loc - scale * sign(u) * log1p(-|u|), u ~ U[finfo.eps - 1, 1) of
    ``shape``, injected (``u``) or drawn from ``generator``."""
    if u is None:
        if generator is None:
            raise ValueError("sample_laplace needs a generator or an injected u")
        lo = torch.finfo(dtype).eps - 1.0
        dev = device if device is not None else generator.device
        u = lo + (1.0 - lo) * torch.rand(shape, generator=generator, device=dev,
                                         dtype=dtype)
    u = u.to(dtype=dtype).reshape(shape)
    return loc - scale * torch.sign(u) * torch.log1p(-torch.abs(u))
