"""Energy functions (JAX twin: ardae_tpu/core/energy.py; reference
utils/energy.py:7-103): the notebook targets (ring, sine, two-arm
mixtures), their box penalty, and the standard-normal prior energy of every
IVAE. Each takes points (n, 2) (the prior any (n, ...)) and returns an
(n, 1) energy (the prior (n,))."""

import math

import torch
import torch.nn.functional as F

EPS = 1e-9


def regularization_func(x):
    """Box penalty relu(|x| - 6)^2 summed over the last axis (reference
    utils/energy.py:7-8)."""
    return torch.sum(F.relu(torch.abs(x) - 6.0) ** 2, dim=-1, keepdim=True)


def _w1(z1):
    return torch.sin(2.0 * math.pi * z1 / 4.0)


def _w2(z1):
    return 3.0 * torch.exp(-0.5 * ((z1 - 1.0) / 0.6) ** 2)


def _w3(z1):
    return 3.0 * torch.sigmoid((z1 - 1.0) / 0.3)


def energy_func1(x):
    """Ring with two bumps (reference utils/energy.py:19-31)."""
    x1 = x[:, :1]
    xnorm = torch.linalg.norm(x, dim=1, keepdim=True)
    energy = 0.5 * ((xnorm - 2.0) / 0.4) ** 2 - torch.log(
        torch.exp(-0.5 * ((x1 - 2.0) / 0.6) ** 2)
        + torch.exp(-0.5 * ((x1 + 2.0) / 0.6) ** 2) + EPS)
    return energy + regularization_func(x)


def energy_func2(x):
    """Sine ridge (reference utils/energy.py:33-41)."""
    x1, x2 = x[:, :1], x[:, 1:]
    return 0.5 * ((x2 - _w1(x1)) / 0.4) ** 2 + regularization_func(x)


def energy_func3(x):
    """Two sine arms split by an exp bump (reference utils/energy.py:43-53)."""
    x1, x2 = x[:, :1], x[:, 1:]
    energy = -torch.log(
        torch.exp(-0.5 * ((x2 - _w1(x1)) / 0.35) ** 2)
        + torch.exp(-0.5 * ((x2 - _w1(x1) + _w2(x1)) / 0.35) ** 2) + EPS)
    return energy + regularization_func(x)


def energy_func4(x):
    """Two sine arms split by a sigmoid (reference utils/energy.py:55-67):
    the target of the ardae_fit example."""
    x1, x2 = x[:, :1], x[:, 1:]
    energy = -torch.log(
        torch.exp(-0.5 * ((x2 - _w1(x1)) / 0.4) ** 2)
        + torch.exp(-0.5 * ((x2 - _w1(x1) + _w3(x1)) / 0.35) ** 2) + EPS)
    return energy + regularization_func(x)


def normal_energy_func(x, mu=0.0, logvar=0.0):
    """-log N(x; mu, e^logvar) summed over features, per row (reference
    utils/energy.py:69-78)."""
    x = x.reshape(x.shape[0], -1)
    elem = 0.5 * (logvar + (x - mu) ** 2 / math.exp(logvar)
                  + math.log(2.0 * math.pi))
    return elem.sum(dim=1)


def normal_prob(x, mu=0.0, std=1.0):
    """exp(-normal_energy) (reference utils/energy.py:94-103)."""
    return torch.exp(-normal_energy_func(x, mu, math.log(std ** 2)))
