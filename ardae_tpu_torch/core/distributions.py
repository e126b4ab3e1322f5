"""The uniform distribution on a hypersphere (JAX twin:
ardae_tpu/core/distributions.py; reference utils/distributions.py, whose
sampler refers to undefined names: this is its evident intent)."""

import math

import torch


def sample_hyperspherical_uniform(batch_size, sample_size, dim, generator=None,
                                  eps=None, device=None):
    """Uniform points on S^dim in R^(dim+1), (batch_size, sample_size,
    dim+1): a normal draw (``eps`` injected, or from ``generator``) over its
    norm."""
    shape = (batch_size, sample_size, dim + 1)
    if eps is None:
        if generator is None:
            raise ValueError("needs a generator or an injected eps")
        eps = torch.randn(shape, generator=generator,
                          device=device if device is not None else generator.device)
    x = eps.reshape(shape)
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def hyperspherical_uniform_entropy(dim):
    """log of the surface area of S^dim (the uniform's entropy)."""
    d = dim + 1
    return math.log(2.0) + (d / 2.0) * math.log(math.pi) - math.lgamma(d / 2.0)


def hyperspherical_uniform_logprob(x, dim):
    """The constant -log area for points on the sphere, x.shape[:-1]."""
    return torch.full(x.shape[:-1], -hyperspherical_uniform_entropy(dim),
                      dtype=x.dtype, device=x.device)
