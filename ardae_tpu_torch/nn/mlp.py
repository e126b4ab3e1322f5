"""MLP-family modules (JAX twin: ardae_tpu/nn/mlp.py).

Shared shape law: ``num_hidden_layers`` hidden layers of width ``hidden_dim``
followed by one output layer ``fc``; ``use_nonlinearity_output`` applies the
activation after fc. Unlike flax, torch needs the input width up front.
``MLP(xavier=True)`` is the JAX ``_XavierMLP`` (models/ivae/mnist.py:20):
xavier-uniform weights and zero biases in every layer.
``ContextConcatMLP`` draws its output layer's weight from N(0, 1) and
leaves its bias at the default (the reference's reset_parameters, e.g.
models/ivae/toy.py:146-147), with no output activation: the form its one
user, the ``concat`` toy encoder, builds. The other context MLPs of the toy
encoders wait (ROADMAP queue 1).
"""

import torch
import torch.nn as nn

from ardae_tpu_torch.nn.activations import get_nonlinear_func
from ardae_tpu_torch.nn.linear import Linear, ResLinear


class MLP(nn.Module):
    def __init__(self, input_dim, hidden_dim, output_dim, nonlinearity="relu",
                 num_hidden_layers=1, use_nonlinearity_output=False,
                 xavier=False):
        super().__init__()
        self.afun = get_nonlinear_func(nonlinearity)
        self.use_nonlinearity_output = use_nonlinearity_output
        dims = [input_dim] + [hidden_dim] * num_hidden_layers
        self.layers = nn.ModuleList(
            Linear(dims[i], dims[i + 1], xavier=xavier)
            for i in range(num_hidden_layers))
        self.fc = Linear(dims[-1], output_dim, xavier=xavier)

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
    included (reference models/layers.py:681-724)."""

    def __init__(self, input_dim, context_dim, hidden_dim, output_dim,
                 nonlinearity="relu", num_hidden_layers=1):
        super().__init__()
        self.afun = get_nonlinear_func(nonlinearity)
        dims = [input_dim] + [hidden_dim] * num_hidden_layers
        self.layers = nn.ModuleList(
            Linear(dims[i] + context_dim, dims[i + 1])
            for i in range(num_hidden_layers))
        self.fc = Linear(dims[-1] + context_dim, output_dim, normal=True)

    def forward(self, x, ctx):
        h = x.reshape(x.shape[0], -1)
        ctx = ctx.reshape(ctx.shape[0], -1)
        for layer in self.layers:
            h = self.afun(layer(torch.cat([h, ctx], dim=1)))
        return self.fc(torch.cat([h, ctx], dim=1))
