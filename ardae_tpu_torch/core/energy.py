"""The standard-normal prior energy of every IVAE
(JAX twin: ardae_tpu/core/energy.py; reference utils/energy.py:69-78)."""

import math


def normal_energy_func(x, mu=0.0, logvar=0.0):
    """-log N(x; mu, e^logvar) summed over features, per row."""
    x = x.reshape(x.shape[0], -1)
    elem = 0.5 * (logvar + (x - mu) ** 2 / math.exp(logvar)
                  + math.log(2.0 * math.pi))
    return elem.sum(dim=1)
