"""Port layers against their flax twins, fp32, rtol 1e-5 / atol 1e-6.
Conv layers take NHWC in JAX and NCHW in the port: inputs and outputs are
transposed at the comparison."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ardae_tpu.nn import conv as jconv
from ardae_tpu.nn import linear as jlin
from ardae_tpu.nn import mlp as jmlp
from ardae_tpu.nn.activations import get_nonlinear_func as jact
from ardae_tpu_torch.nn import conv as tconv
from ardae_tpu_torch.nn import linear as tlin
from ardae_tpu_torch.nn import mlp as tmlp
from ardae_tpu_torch.nn.activations import get_nonlinear_func as tact
from torch_parity import close, init, loaded, rand, t

RTOL, ATOL = 1e-5, 1e-6


@pytest.mark.parametrize("name", ["elu", "softplus", "relu", "tanh"])
def test_activation(name):
    x = rand(0, 64, 5, scale=4.0)
    close(tact(name)(t(x)), jact(name)(x), RTOL, ATOL)


def test_activation_unknown_raises():
    with pytest.raises(NotImplementedError):
        tact("gelu")


def test_linear():
    x = rand(1, 7, 12)
    jm = jlin.Linear(5)
    p = init(jm, x)
    tm = loaded(tlin.Linear(12, 5), p)
    close(tm(t(x)), jm.apply(p, x), RTOL, ATOL)


@pytest.mark.parametrize("norm", [True, False])
def test_wn_linear(norm):
    x = rand(2, 7, 12)
    jm = jlin.WeightNormalizedLinear(6, norm=norm)
    p = init(jm, x)
    # a non-unit scale exercises the scale path
    p["params"]["scale"] = jnp.linspace(0.5, 1.5, 6)
    tm = loaded(tlin.WeightNormalizedLinear(12, 6, norm=norm), p)
    close(tm(t(x)), jm.apply(p, x), RTOL, ATOL)


@pytest.mark.parametrize("same_dim,oper", [(False, "wnlinear"), (True, "wnlinear"),
                                           (False, "linear")])
def test_res_linear(same_dim, oper):
    x = rand(3, 9, 10)
    out = 10 if same_dim else 6
    jm = jlin.ResLinear(out, same_dim=same_dim, oper=oper)
    p = init(jm, x)
    tm = loaded(tlin.ResLinear(10, out, same_dim=same_dim, oper=oper), p)
    close(tm(t(x)), jm.apply(p, x), RTOL, ATOL)


@pytest.mark.parametrize("layers", [1, 2])
def test_res_mlp(layers):
    x = rand(4, 8, 20)
    jm = jmlp.ResMLP(hidden_dim=16, output_dim=4, nonlinearity="elu",
                     num_hidden_layers=layers)
    p = init(jm, x)
    tm = loaded(tmlp.ResMLP(20, 16, 4, "elu", layers), p)
    close(tm(t(x)), jm.apply(p, x), RTOL, ATOL)


def test_mlp():
    x = rand(5, 8, 6)
    jm = jmlp.MLP(hidden_dim=16, output_dim=3, nonlinearity="softplus",
                  num_hidden_layers=2, use_nonlinearity_output=True)
    p = init(jm, x)
    tm = loaded(tmlp.MLP(6, 16, 3, "softplus", 2, True), p)
    close(tm(t(x)), jm.apply(p, x), RTOL, ATOL)


def _nchw(a):
    return t(np.transpose(a, (0, 3, 1, 2)))


def _nhwc(x):
    return x.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("stride", [1, 2])
def test_wn_conv2d(stride):
    x = rand(6, 2, 9, 9, 3)
    jm = jconv.WNConv2d(5, 3, stride, 1)
    p = init(jm, x)
    tm = loaded(tconv.WNConv2d(3, 5, 3, stride, 1), p)
    np.testing.assert_allclose(_nhwc(tm(_nchw(x))), jm.apply(p, x), RTOL, ATOL)


def test_res_conv2d():
    x = rand(7, 2, 14, 14, 4)
    jm = jconv.ResConv2d(8, 3, 2, 1)
    p = init(jm, x)
    tm = loaded(tconv.ResConv2d(4, 8, 3, 2, 1), p)
    np.testing.assert_allclose(_nhwc(tm(_nchw(x))), jm.apply(p, x), RTOL, ATOL)


def test_res_linear2():
    x = rand(8, 5, 24)
    jm = jconv.ResLinear2(16)
    p = init(jm, x)
    tm = loaded(tconv.ResLinear2(24, 16), p)
    close(tm(t(x)), jm.apply(p, x), RTOL, ATOL)


@pytest.mark.parametrize("hw", [(4, 4), (7, 7), (3, 5)])
def test_upsample_align_corners(hw):
    x = rand(9, 2, hw[0], hw[1], 3)
    got = tconv.upsample_bilinear_align_corners(_nchw(x), 2)
    np.testing.assert_allclose(_nhwc(got), jconv.upsample_bilinear_align_corners(x, 2),
                               RTOL, ATOL)
