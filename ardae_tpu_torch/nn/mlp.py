"""MLP-family modules (JAX twin: ardae_tpu/nn/mlp.py).

Shared shape law: ``num_hidden_layers`` hidden layers of width ``hidden_dim``
followed by one output layer ``fc``; ``use_nonlinearity_output`` applies the
activation after fc. Unlike flax, torch needs the input width up front.
``MLP(xavier=True)`` is the JAX ``_XavierMLP`` (models/ivae/mnist.py:20):
xavier-uniform weights and zero biases in every layer.
``gaussian_out_init=True`` draws the output layer's weights from N(0, 1)
and leaves its biases at the default (the reference's reset_parameters,
e.g. models/ivae/toy.py:146-147). The context MLPs feed the context to
every layer; each is one of the toy encoders' fusions
(models/ivae/toy.py), which builds it with no output activation and, under
``init_mode="gaussian"``, ``gaussian_out_init=True``. Every option takes
the JAX twin's name and default.
"""

import torch
import torch.nn as nn

from ardae_tpu_torch.nn.activations import get_nonlinear_func
from ardae_tpu_torch.nn.linear import (
    ContextLinear,
    ContextResLinear,
    ContextSoftPlusLinear,
    ContextSoftPlusWeightNormalizedLinear,
    ContextWeightNormalizedLinear,
    Linear,
    ResLinear,
    SimplifiedBilinear,
    StackedWeightNormalizedSimplifiedBilinear,
    WeightNormalizedLinear,
    WeightNormalizedSimplifiedBilinear,
)


class MLP(nn.Module):
    def __init__(self, input_dim, hidden_dim, output_dim, nonlinearity="relu",
                 num_hidden_layers=1, use_nonlinearity_output=False,
                 xavier=False, gaussian_out_init=False):
        super().__init__()
        self.afun = get_nonlinear_func(nonlinearity)
        self.use_nonlinearity_output = use_nonlinearity_output
        dims = [input_dim] + [hidden_dim] * num_hidden_layers
        self.layers = nn.ModuleList(
            Linear(dims[i], dims[i + 1], xavier=xavier)
            for i in range(num_hidden_layers))
        self.fc = Linear(dims[-1], output_dim, xavier=xavier,
                         normal_std=1.0 if gaussian_out_init else None)

    def forward(self, x):
        h = x.reshape(x.shape[0], -1)
        for layer in self.layers:
            h = self.afun(layer(h))
        out = self.fc(h)
        return self.afun(out) if self.use_nonlinearity_output else out


class WNMLP(nn.Module):
    """MLP of WeightNormalizedLinear layers, the hidden ones row-normalized,
    the output layer if ``use_norm_output``."""

    def __init__(self, input_dim, hidden_dim, output_dim, nonlinearity="relu",
                 num_hidden_layers=1, use_nonlinearity_output=False,
                 use_norm_output=False):
        super().__init__()
        self.afun = get_nonlinear_func(nonlinearity)
        self.use_nonlinearity_output = use_nonlinearity_output
        dims = [input_dim] + [hidden_dim] * num_hidden_layers
        self.layers = nn.ModuleList(
            WeightNormalizedLinear(dims[i], dims[i + 1])
            for i in range(num_hidden_layers))
        self.fc = WeightNormalizedLinear(dims[-1], output_dim,
                                         norm=use_norm_output)

    def forward(self, x):
        h = x.reshape(x.shape[0], -1)
        for layer in self.layers:
            h = self.afun(layer(h))
        out = self.fc(h)
        return self.afun(out) if self.use_nonlinearity_output else out


class ResMLP(nn.Module):
    """Stack of ResLinear blocks (the ``res-wn-mlp`` / ``res-mlp`` heads)."""

    def __init__(self, input_dim, hidden_dim, output_dim, nonlinearity="relu",
                 num_hidden_layers=1, use_nonlinearity_output=False,
                 layer="wnlinear", use_norm=False, use_norm_output=False):
        super().__init__()
        self.afun = get_nonlinear_func(nonlinearity)
        self.use_nonlinearity_output = use_nonlinearity_output
        blocks, prev = [], input_dim
        for _ in range(num_hidden_layers):
            blocks.append(ResLinear(prev, hidden_dim, same_dim=prev == hidden_dim,
                                    oper=layer, norm=use_norm))
            prev = hidden_dim
        self.layers = nn.ModuleList(blocks)
        self.fc = ResLinear(prev, output_dim, same_dim=prev == output_dim,
                            oper=layer, norm=use_norm_output)

    def forward(self, x):
        h = x.reshape(x.shape[0], -1)
        for block in self.layers:
            h = self.afun(block(h))
        out = self.fc(h)
        return self.afun(out) if self.use_nonlinearity_output else out


class ContextConcatMLP(nn.Module):
    """The context concatenated onto every layer's input, the output layer's
    included (reference models/layers.py:681-724); ``gaussian_out_init``:
    the output weight N(0, 1)."""

    def __init__(self, input_dim, context_dim, hidden_dim, output_dim,
                 nonlinearity="relu", num_hidden_layers=1,
                 use_nonlinearity_output=False, gaussian_out_init=False):
        super().__init__()
        self.afun = get_nonlinear_func(nonlinearity)
        self.use_nonlinearity_output = use_nonlinearity_output
        dims = [input_dim] + [hidden_dim] * num_hidden_layers
        self.layers = nn.ModuleList(
            Linear(dims[i] + context_dim, dims[i + 1])
            for i in range(num_hidden_layers))
        self.fc = Linear(dims[-1] + context_dim, output_dim,
                         normal_std=1.0 if gaussian_out_init else None)

    def forward(self, x, ctx):
        h = x.reshape(x.shape[0], -1)
        ctx = ctx.reshape(ctx.shape[0], -1)
        for layer in self.layers:
            h = self.afun(layer(torch.cat([h, ctx], dim=1)))
        out = self.fc(torch.cat([h, ctx], dim=1))
        return self.afun(out) if self.use_nonlinearity_output else out


class ContextResMLP(nn.Module):
    """Stack of ContextResLinear blocks, the context fed to each; ``use_norm``
    row-normalizes the hidden blocks' products, ``use_norm_output`` the
    output block's."""

    def __init__(self, input_dim, context_dim, hidden_dim, output_dim,
                 nonlinearity="relu", num_hidden_layers=1,
                 use_nonlinearity_output=False, use_norm=False,
                 use_norm_output=False):
        super().__init__()
        self.afun = get_nonlinear_func(nonlinearity)
        self.use_nonlinearity_output = use_nonlinearity_output
        blocks, prev = [], input_dim
        for _ in range(num_hidden_layers):
            blocks.append(ContextResLinear(prev, context_dim, hidden_dim,
                                           same_dim=prev == hidden_dim,
                                           norm=use_norm))
            prev = hidden_dim
        self.layers = nn.ModuleList(blocks)
        self.fc = ContextResLinear(prev, context_dim, output_dim,
                                   same_dim=prev == output_dim,
                                   norm=use_norm_output)

    def forward(self, x, ctx):
        h = x.reshape(x.shape[0], -1)
        ctx = ctx.reshape(ctx.shape[0], -1)
        for block in self.layers:
            h = self.afun(block(h, ctx))
        out = self.fc(h, ctx)
        return self.afun(out) if self.use_nonlinearity_output else out


class _ContextLayerMLP(nn.Module):
    """``num_hidden_layers`` context layers of width ``hidden_dim`` and an
    output one ``fc``, each taking (h, ctx); a subclass names the layer and
    what ``gaussian`` (``gaussian_out_init``, output layer only) draws from
    N(0, 1) in it."""

    def __init__(self, input_dim, context_dim, hidden_dim, output_dim,
                 nonlinearity="relu", num_hidden_layers=3,
                 use_nonlinearity_output=False, gaussian_out_init=False):
        super().__init__()
        self.afun = get_nonlinear_func(nonlinearity)
        self.hidden_dim = hidden_dim
        self.use_nonlinearity_output = use_nonlinearity_output
        dims = [input_dim] + [hidden_dim] * num_hidden_layers
        self.layers = nn.ModuleList(
            self._layer(dims[i], context_dim, dims[i + 1], False)
            for i in range(num_hidden_layers))
        self.fc = self._layer(dims[-1], context_dim, output_dim,
                              gaussian_out_init)

    def _layer(self, in_dim, ctx_dim, out_dim, gaussian):
        raise NotImplementedError

    def forward(self, x, ctx):
        h = x.reshape(x.shape[0], -1)
        ctx = ctx.reshape(ctx.shape[0], -1)
        for layer in self.layers:
            h = self.afun(layer(h, ctx))
        out = self.fc(h, ctx)
        return self.afun(out) if self.use_nonlinearity_output else out


class ContextScaleMLP(_ContextLayerMLP):
    """FiLM at every layer (reference models/layers.py:726-778); the
    Gaussian output layer draws direction and cbias's weight from N(0, 1)
    (reference models/ivae/toy.py:233-237)."""

    def _layer(self, in_dim, ctx_dim, out_dim, gaussian):
        return ContextLinear(in_dim, ctx_dim, out_dim, gaussian=gaussian)


class ContextWNScaleMLP(_ContextLayerMLP):
    """The JAX twin draws no layer of it from N(0, 1): ``gaussian`` is moot."""

    def _layer(self, in_dim, ctx_dim, out_dim, gaussian):
        return ContextWeightNormalizedLinear(in_dim, ctx_dim, out_dim)


class ContextSPScaleMLP(_ContextLayerMLP):
    """The JAX twin draws no layer of it from N(0, 1): ``gaussian`` is moot."""

    def _layer(self, in_dim, ctx_dim, out_dim, gaussian):
        return ContextSoftPlusLinear(in_dim, ctx_dim, out_dim)


class ContextSPWNScaleMLP(_ContextLayerMLP):
    """The JAX twin draws no layer of it from N(0, 1): ``gaussian`` is moot."""

    def _layer(self, in_dim, ctx_dim, out_dim, gaussian):
        return ContextSoftPlusWeightNormalizedLinear(in_dim, ctx_dim, out_dim)


class ContextBilinearMLP(_ContextLayerMLP):
    """SimplifiedBilinear at every layer (reference models/layers.py:932-986)."""

    def _layer(self, in_dim, ctx_dim, out_dim, gaussian):
        return SimplifiedBilinear(in_dim, ctx_dim, out_dim, gaussian=gaussian)


class ContextWNBilinearMLP(_ContextLayerMLP):
    def _layer(self, in_dim, ctx_dim, out_dim, gaussian):
        return WeightNormalizedSimplifiedBilinear(
            in_dim, ctx_dim, out_dim, gaussian=gaussian)


class ContextSWNBilinearMLP(_ContextLayerMLP):
    def _layer(self, in_dim, ctx_dim, out_dim, gaussian):
        return StackedWeightNormalizedSimplifiedBilinear(
            in_dim, ctx_dim, self.hidden_dim, out_dim, gaussian=gaussian)
