"""Shared helpers of the port's parity tests (tests/test_torch_*.py): the same
inputs, made with numpy from a seed, go through a JAX function and its
PyTorch counterpart; parameters cross through ardae_tpu_torch.convert."""

import jax
import numpy as np
import torch

from ardae_tpu_torch.convert import flax_to_state_dict, load_flax_params

torch.set_num_threads(2)


def rand(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def init(module, *args, seed=0, method=None):
    """flax params of ``module`` for example inputs ``args`` (numpy)."""
    kw = {} if method is None else {"method": method}
    return module.init(jax.random.PRNGKey(seed), *args, **kw)


def loaded(torch_module, params):
    return load_flax_params(torch_module, params)


def grads_as_state_dict(grads, torch_module):
    """A flax gradient tree in the torch module's layout (same linear map as
    the parameters)."""
    return flax_to_state_dict(grads, torch_module)


def close(actual, expected, rtol=1e-5, atol=1e-6, msg=""):
    a = actual.detach().cpu().numpy() if isinstance(actual, torch.Tensor) else np.asarray(actual)
    np.testing.assert_allclose(a, np.asarray(expected), rtol=rtol, atol=atol,
                               err_msg=msg)
