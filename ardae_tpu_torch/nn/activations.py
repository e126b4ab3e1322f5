"""Nonlinearity registry (reference utils/models.py:14-32)."""

import torch
import torch.nn.functional as F

_NONLIN = {
    "relu": F.relu,
    "elu": F.elu,
    "tanh": torch.tanh,
    "softplus": F.softplus,
}


def get_nonlinear_func(name: str = "elu"):
    try:
        return _NONLIN[name]
    except KeyError:
        raise NotImplementedError(
            f"nonlinearity {name!r} is not ported yet (ROADMAP queue 1, "
            "slice 1, item 3)") from None
