"""The rest of the torchkit layers (JAX twin: ardae_tpu/nn/torchkit_extras.py;
reference models/layers2.py), which no model of either package builds:

  * CWNlinear / CWNconv2d: a context scale and bias over a row-normalised
    weight (the conv one NCHW, its weight OIHW);
  * WNBilinear: a true bilinear form with weight-normalised slices;
  * GatingLinear: a sigmoid-gated weight-normalised linear;
  * the Sequential plumbing: Reshape, Slice (and its ``slicer[...]``
    factory), Lambda, ContextWrapper and SequentialFlow, whose ``sample``
    pushes x ~ N(0, I) with logdet ~ U(0, 1) through its blocks.

Each layer draws its parameters by the JAX twin's law; ``convert.py`` maps
one package's parameters onto the other's.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ardae_tpu_torch.core.precision import promote
from ardae_tpu_torch.nn.initializers import normal_, torch_default_, uniform_
from ardae_tpu_torch.nn.linear import Linear, WeightNormalizedLinear, _row_normalize, linear


class CWNlinear(nn.Module):
    """(reference models/layers2.py:95-135) out = cscale(ctx) * (x @ W_norm^T)
    + cbias(ctx); ``direction`` (out, in) and the cscale / cbias weights ~
    N(0, 0.001^2), their biases the torch default."""

    def __init__(self, in_features, ctx_features, out_features, norm=True):
        super().__init__()
        self.in_features, self.norm = in_features, norm
        self.direction = nn.Parameter(torch.empty(out_features, in_features))
        self.cscale = Linear(ctx_features, out_features, normal_std=0.001)
        self.cbias = Linear(ctx_features, out_features, normal_std=0.001)

    def init_params(self, generator):
        with torch.no_grad():
            normal_(self.direction, generator).mul_(0.001)

    def forward(self, x, ctx):
        w = _row_normalize(self.direction) if self.norm else self.direction
        return self.cscale(ctx) * linear(x, w) + self.cbias(ctx)


class CWNconv2d(nn.Module):
    """(reference models/layers2.py:267-303) a normalised conv, scaled and
    shifted per output channel by the context: x (N, C, H, W), ctx (N,
    ctx_dim); ``direction`` OIHW with the torch conv default, each output
    filter normalised over (in, k, k)."""

    def __init__(self, in_channels, ctx_features, out_channels, kernel_size,
                 stride=1, padding=0, norm=True):
        super().__init__()
        k = kernel_size
        self.stride, self.padding, self.norm = stride, padding, norm
        self.fan_in = in_channels * k * k
        self.direction = nn.Parameter(torch.empty(out_channels, in_channels, k, k))
        self.cscale = Linear(ctx_features, out_channels)
        self.cbias = Linear(ctx_features, out_channels)

    def init_params(self, generator):
        uniform_(self.direction, 1.0 / math.sqrt(self.fan_in), generator)

    def forward(self, x, ctx):
        w = self.direction
        if self.norm:
            w = w / torch.sqrt(torch.sum(w ** 2, dim=(1, 2, 3), keepdim=True))
        pre = F.conv2d(*promote(x, w), stride=self.stride, padding=self.padding)
        return pre * self.cscale(ctx)[:, :, None, None] + self.cbias(ctx)[:, :, None, None]


class WNBilinear(nn.Module):
    """(reference models/layers2.py:139-173) out_o = scale_o * <x1, W_o x2> /
    ||W_o|| + bias_o; ``direction`` (out, in1, in2) and the bias ~
    U(+-1/sqrt(in1)), scale 1."""

    def __init__(self, in1_features, in2_features, out_features, use_bias=True):
        super().__init__()
        self.in1_features = in1_features
        self.direction = nn.Parameter(
            torch.empty(out_features, in1_features, in2_features))
        self.scale = nn.Parameter(torch.ones(out_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if use_bias else None

    def init_params(self, generator):
        torch_default_(self.direction, self.bias, self.in1_features, generator)
        with torch.no_grad():
            self.scale.fill_(1.0)

    def forward(self, x1, x2):
        d = self.direction
        nrm = torch.sqrt(torch.sum(d ** 2, dim=(1, 2), keepdim=True))
        weight = d / nrm * self.scale[:, None, None]
        out = torch.einsum("ni,oij,nj->no", *promote(x1, weight, x2))
        return out if self.bias is None else out + self.bias


class GatingLinear(nn.Module):
    """(reference models/layers2.py:355-369) sigmoid(gate(x)) * dot(x), both
    weight-normalised."""

    def __init__(self, in_features, out_features):
        super().__init__()
        self.dot = WeightNormalizedLinear(in_features, out_features)
        self.gate = WeightNormalizedLinear(in_features, out_features)

    def forward(self, x):
        return torch.sigmoid(self.gate(x)) * self.dot(x)


# torchkit Sequential plumbing (reference models/layers2.py:373-462)

class Reshape(nn.Module):
    """(reference :373-380) a view of a fixed shape."""

    def __init__(self, shape):
        super().__init__()
        self.shape = tuple(shape)

    def forward(self, x):
        return x.reshape(self.shape)


class Slice(nn.Module):
    """(reference :383-396) indexing by a stored slice."""

    def __init__(self, slc):
        super().__init__()
        self.slc = slc

    def forward(self, x):
        return x[self.slc]


class _SliceFactory:
    def __getitem__(self, slc):
        return Slice(slc if isinstance(slc, tuple) else (slc,))


#: ``slicer[:, :, :-1, :-1]`` -> a Slice module (reference :399)
slicer = _SliceFactory()


class Lambda(nn.Module):
    """(reference :402-409) a function as a module."""

    def __init__(self, function):
        super().__init__()
        self.function = function

    def forward(self, x):
        return self.function(x)


class ContextWrapper(nn.Module):
    """(reference :441-448) an (input, context) pair through a module that
    takes no context; the context passes on."""

    def __init__(self, module):
        super().__init__()
        self.module = module

    def forward(self, inputs):
        x, ctx = inputs
        return self.module(x), ctx


class SequentialFlow(nn.Module):
    """(reference :412-438) a chain of flow blocks over (x, logdet, context)
    triples. ``sample`` draws x ~ N(0, I) (n, dim) and the logdet seed ~
    U(0, 1) (n,) as the reference does, takes a zero context of
    ``context_dim`` unless one is given, and pushes the triple through."""

    def __init__(self, blocks, dim=2, context_dim=1):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.dim, self.context_dim = dim, context_dim

    def forward(self, inputs):
        x, logdet, ctx = inputs
        for block in self.blocks:
            x, logdet, ctx = block((x, logdet, ctx))
        return x, logdet, ctx

    def sample(self, n=1, context=None, generator=None, x=None, logdet=None):
        """``x`` (n, dim) and ``logdet`` (n,) injected, or drawn from
        ``generator``, x first."""
        if x is None or logdet is None:
            if generator is None:
                raise ValueError("sample needs a generator or injected x and logdet")
            dev = generator.device
            x = torch.randn(n, self.dim, generator=generator, device=dev)
            logdet = torch.rand(n, generator=generator, device=dev)
        if context is None:
            context = torch.zeros(n, self.context_dim, device=x.device)
        return self((x, logdet, context))
