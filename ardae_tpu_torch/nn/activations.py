"""Nonlinearity registry (JAX twin: ardae_tpu/nn/activations.py; reference
utils/models.py:14-32)."""

import torch
import torch.nn.functional as F


def _csoftplus(x):
    # the reference's hand-rolled softplus, log(exp(x) + 1), as JAX's logaddexp
    return torch.logaddexp(x, x.new_zeros(()))


def _leaky_relu02(x):
    return F.leaky_relu(x, negative_slope=0.2)


def _swish(x):
    return x * torch.sigmoid(x)


_NONLIN = {
    "relu": F.relu,
    "elu": F.elu,
    "tanh": torch.tanh,
    "softplus": F.softplus,
    "csoftplus": _csoftplus,
    "leaky_relu": _leaky_relu02,
    "swish": _swish,
}


def get_nonlinear_func(name: str = "elu"):
    try:
        return _NONLIN[name]
    except KeyError:
        raise NotImplementedError(f"unknown nonlinearity: {name}") from None
