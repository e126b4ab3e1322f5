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


def loss_recon_bernoulli_with_logit(logit, x, reduce: str = "per_item"):
    """Stable BCE-with-logits (reference utils/vae.py:21-29):
    max(l, 0) - l*x + log(1 + exp(-|l|))."""
    neg_ll = (torch.clamp(logit, min=0.0) - logit * x
              + torch.log1p(torch.exp(-torch.abs(logit))))
    return _reduce(neg_ll, reduce)
