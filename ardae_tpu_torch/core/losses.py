"""ELBO building blocks of the flagship slice (JAX twin: ardae_tpu/core/losses.py).

``reduce='sum'`` sums every element, ``reduce='per_item'`` sums all non-batch
axes (axis 0 is the batch), ``reduce='none'`` returns the elements.
"""

import torch


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


def iwae_bound(logw, dim: int = -1, eps: float = 1e-10):
    """log mean_k exp(logw_k) with the reference's max shift and eps
    (models/ivae/mnist.py:430-434): log(mean(exp(lw - max)) + 1e-10) + max,
    the max detached. The eps keeps the numbers comparable with the
    reference's to < 0.2 nats."""
    logw_max = torch.amax(logw, dim=dim, keepdim=True).detach()
    rprob = torch.exp(logw - logw_max)
    out = torch.log(torch.mean(rprob, dim=dim, keepdim=True) + eps) + logw_max
    return torch.squeeze(out, dim=dim)
