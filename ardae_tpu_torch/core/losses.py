"""ELBO building blocks (JAX twin: ardae_tpu/core/losses.py).

``reduce='sum'`` sums every element, ``reduce='per_item'`` sums all non-batch
axes (axis 0 is the batch), ``reduce='none'`` returns the elements.
"""

import math

import torch

_LOG_2PI = math.log(2.0 * math.pi)


def _reduce(elem: torch.Tensor, reduce: str) -> torch.Tensor:
    if reduce == "none":
        return elem
    if reduce == "sum":
        return torch.sum(elem)
    if reduce == "per_item":
        return torch.sum(elem.reshape(elem.shape[0], -1), dim=1)
    raise ValueError(f"unknown reduce mode: {reduce}")


def reduce_batch(per_item: torch.Tensor, reduce: str) -> torch.Tensor:
    """Batch-level reduction of per-item losses or bounds: ``'mean'`` -> the
    scalar mean over the batch, ``'per_item'`` -> the (bsz,) vector."""
    if reduce == "mean":
        return torch.mean(per_item)
    if reduce == "per_item":
        return per_item
    raise ValueError(f"reduce must be 'mean' or 'per_item', got {reduce!r}")


def loss_recon_bernoulli_with_logit(logit, x, reduce: str = "per_item"):
    """Stable BCE-with-logits (reference utils/vae.py:21-29):
    max(l, 0) - l*x + log(1 + exp(-|l|))."""
    neg_ll = (torch.clamp(logit, min=0.0) - logit * x
              + torch.log1p(torch.exp(-torch.abs(logit))))
    return _reduce(neg_ll, reduce)


def loss_recon_bernoulli(p, x, eps: float = 1e-7):
    """Summed BCE given probabilities, clipped to [eps, 1 - eps] (reference
    utils/vae.py:32-34: F.binary_cross_entropy, size_average=False)."""
    p = torch.clamp(p, eps, 1.0 - eps)
    return -torch.sum(x * torch.log(p) + (1.0 - x) * torch.log(1.0 - p))


def loss_recon_gaussian(mu, logvar, x, const=None, reduce: str = "per_item"):
    """Gaussian negative log-likelihood (reference utils/vae.py:36-52)."""
    elem = logvar + (x - mu) ** 2 / torch.exp(logvar) + _LOG_2PI
    if const is not None:
        elem = elem + const
    return 0.5 * _reduce(elem, reduce)


def loss_recon_gaussian_w_fixed_var(mu, x, std: float = 1.0, const=None,
                                    reduce: str = "per_item",
                                    add_logvar: bool = True):
    """Gaussian negative log-likelihood with a fixed scalar std (reference
    utils/vae.py:54-76)."""
    var = std ** 2
    elem = (x - mu) ** 2 / var + _LOG_2PI
    if add_logvar:
        elem = elem + math.log(var)
    if const is not None:
        elem = elem + const
    return 0.5 * _reduce(elem, reduce)


def loss_kld_gaussian(mu, logvar, reduce: str = "per_item"):
    """KL( N(mu, e^logvar) || N(0, I) ) (reference utils/vae.py:78-92)."""
    elem = 1.0 + logvar - mu ** 2 - torch.exp(logvar)
    return -0.5 * _reduce(elem, reduce)


def loss_kld_gaussian_vs_gaussian(mu1, logvar1, mu2, logvar2,
                                  reduce: str = "per_item"):
    """KL( N(mu1, e^logvar1) || N(mu2, e^logvar2) ) (reference
    utils/vae.py:94-114): the KL(q(z0|x) || r(z0|x,z)) term of the aux
    baselines."""
    elem = (-logvar2 + logvar1
            - (torch.exp(logvar1) + (mu1 - mu2) ** 2) / torch.exp(logvar2) + 1.0)
    return -0.5 * _reduce(elem, reduce)


def loss_entropy_gaussian(logvar, reduce: str = "per_item"):
    """Negative differential entropy terms of a diagonal Gaussian
    (reference utils/stat.py:17-28)."""
    return 0.5 * _reduce(logvar + 1.0 + _LOG_2PI, reduce)


def iwae_bound(logw, dim: int = -1, eps: float = 1e-10):
    """log mean_k exp(logw_k) with the reference's max shift and eps
    (models/ivae/mnist.py:430-434): log(mean(exp(lw - max)) + 1e-10) + max,
    the max detached. The eps keeps the numbers comparable with the
    reference's to < 0.2 nats."""
    logw_max = torch.amax(logw, dim=dim, keepdim=True).detach()
    rprob = torch.exp(logw - logw_max)
    out = torch.log(torch.mean(rprob, dim=dim, keepdim=True) + eps) + logw_max
    return torch.squeeze(out, dim=dim)
