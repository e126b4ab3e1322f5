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


def check_round_trip(params, torch_module):
    """state_dict_to_flax inverts flax_to_state_dict: every leaf of the flax
    tree comes back bit for bit."""
    import jax

    from ardae_tpu_torch.convert import state_dict_to_flax

    back = state_dict_to_flax(torch_module.state_dict(), torch_module)["params"]
    flat = jax.tree_util.tree_leaves_with_path(params["params"])
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))


def check_init_law(got, want):
    """A port module's own init (state_dict ``got``) against a JAX init of
    the same widths (``want``, converted), tensor by tensor: equal where
    JAX's is constant (zero biases, weight-normalised layers' unit scales);
    else the same spread (std within 5 % + 2 / sqrt(size)) around 0. A
    one-element tensor has no spread to hold."""
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if not bool(w.any()) or (w.numel() > 1 and float(w.std()) == 0.0):
            assert torch.equal(g, w), k
            continue
        if w.numel() == 1:
            continue
        tol = 0.05 + 2.0 / g.numel() ** 0.5
        assert abs(float(g.std()) / float(w.std()) - 1.0) < tol, k
        assert abs(float(g.mean())) < 5 * float(w.std()) / g.numel() ** 0.5, k
