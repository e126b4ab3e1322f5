"""Distribution heads (JAX twin: ardae_tpu/nn/heads.py; reference
models/reparam.py:12-203).

Heads return distribution parameters only; sampling is
``core/rng.sample_gaussian`` with an injected or generator-drawn noise. The
relaxed samplers (Binary-Concrete, Gumbel-Softmax) wait for the models that
use them (ROADMAP queue 1, slice 5).
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ardae_tpu_torch.nn.linear import Linear

MIN_LOGVAR = -4.0
MAX_LOGVAR = 2.0


def clip_logvar(logvar, mode):
    """Logvar clipping modes (reference models/reparam.py:17-40): none,
    hard [-4, 2], softplus, spm<c> (softplus(l + c) - c), tanh, 2tanh."""
    if mode is None or mode == "none":
        return logvar
    if mode == "hard":
        return torch.clamp(logvar, MIN_LOGVAR, MAX_LOGVAR)
    if mode == "softplus":
        return F.softplus(logvar)
    if mode.startswith("spm"):
        c = float(mode[3:])
        return F.softplus(logvar + c) - c
    if mode == "tanh":
        return torch.tanh(logvar)
    if mode == "2tanh":
        return 2.0 * torch.tanh(logvar)
    raise NotImplementedError(f"unknown logvar clip mode: {mode}")


class NormalHead(nn.Module):
    """Linear mean and linear (clipped) logvar, ``mean_fn`` and
    ``logvar_fn`` (reference models/reparam.py:62-76); ``xavier`` gives both
    xavier-uniform weights and zero biases; ``normal_mean`` draws the mean
    weight from N(0, 1) (the JAX twin's ``mean_kernel_init=normal_init(1.0)``
    of the toy decoders)."""

    def __init__(self, in_features, features, clip=None, xavier=False,
                 normal_mean=False):
        super().__init__()
        self.clip = clip
        self.mean_fn = Linear(in_features, features, xavier=xavier,
                              normal_std=1.0 if normal_mean else None)
        self.logvar_fn = Linear(in_features, features, xavier=xavier)

    def forward(self, h):
        return self.mean_fn(h), clip_logvar(self.logvar_fn(h), self.clip)


class BernoulliHead(nn.Module):
    """Linear logits, ``logit_fn`` (reference models/reparam.py:163-176)."""

    def __init__(self, in_features, features):
        super().__init__()
        self.logit_fn = Linear(in_features, features)

    def forward(self, h):
        return self.logit_fn(h)
