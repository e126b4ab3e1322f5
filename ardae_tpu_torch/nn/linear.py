"""Linear-family layers (JAX twin: ardae_tpu/nn/linear.py; reference
models/layers.py:25-473): plain, weight-normalized and residual linears, the
FiLM-style context linears (scale(ctx) * Wx + bias(ctx)) and their
softplus-gated and row-normalized variants, and the simplified bilinears.

Weights are stored torch-style, (out_features, in_features), raw matrices
(``direction``, ``cscale``, ``path1``, ``path2``) too. Weight-normalized
layers keep the torchkit parameterisation: ``direction`` (out, in), ``scale``
(out,) and ``bias`` (out,); ``norm=True`` normalises each output row over its
in-features (``_row_normalize``: dim 1 here, axis 0 of the twin's (in, out)
kernels). Layers whose reference ``reset_parameters`` draws the output
layer from N(0, 1) take ``gaussian=True``. Every product goes through
``linear``, which promotes an fp32 input against bf16 weights to fp32 as
flax does (core/precision.py).
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ardae_tpu_torch.core.precision import promote
from ardae_tpu_torch.nn.initializers import (
    normal_,
    torch_default_,
    uniform_,
    xavier_,
)


def linear(x, weight, bias=None):
    """F.linear on the operands' common dtype (JAX's promotion)."""
    return F.linear(*promote(x, weight, bias))


def _row_normalize(w):
    """Each output row of an (out, in) weight scaled to unit norm."""
    return w / torch.sqrt(torch.sum(w * w, dim=1, keepdim=True))


def _uniform_or_normal(w, fan_in, gaussian, generator):
    """U(+-1/sqrt(fan_in)) (the torch-1.2 default), or N(0, 1)."""
    if gaussian:
        normal_(w, generator)
    else:
        uniform_(w, 1.0 / math.sqrt(fan_in), generator)


class Linear(nn.Module):
    """nn.Linear with torch-1.2 default init, or xavier-uniform weight and
    zero bias (``xavier=True``). ``normal_std=s`` then draws the weight from
    N(0, s^2) instead and leaves the bias as it was (the JAX twin's
    ``kernel_init=normal_init(s)``)."""

    def __init__(self, in_features, out_features, use_bias=True, xavier=False,
                 normal_std=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.xavier, self.normal_std = xavier, normal_std
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = (nn.Parameter(torch.empty(out_features))
                     if use_bias else None)

    def init_params(self, generator):
        if self.xavier:
            xavier_(self.weight, self.bias, self.in_features,
                    self.out_features, generator)
        else:
            torch_default_(self.weight, self.bias, self.in_features, generator)
        if self.normal_std is not None:
            with torch.no_grad():
                normal_(self.weight, generator).mul_(self.normal_std)

    def forward(self, x):
        return linear(x, self.weight, self.bias)


class WeightNormalizedLinear(nn.Module):
    """torchkit WNlinear (reference models/layers.py:25-63):
    weight = scale[:, None] * direction / ||direction||_row  (norm=True)
           = scale[:, None] * direction                       (norm=False)."""

    def __init__(self, in_features, out_features, use_bias=True, norm=True):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.norm = norm
        self.direction = nn.Parameter(torch.empty(out_features, in_features))
        self.scale = nn.Parameter(torch.ones(out_features))
        self.bias = (nn.Parameter(torch.empty(out_features))
                     if use_bias else None)

    def init_params(self, generator):
        torch_default_(self.direction, self.bias, self.in_features, generator)
        with torch.no_grad():
            self.scale.fill_(1.0)

    def forward(self, x):
        # (x @ w) * scale, in the JAX twin's order of operations
        d = _row_normalize(self.direction) if self.norm else self.direction
        y = linear(x, d) * self.scale
        return y if self.bias is None else y + self.bias


class ResLinear(nn.Module):
    """Residual linear block (reference models/layers.py:66-85):
    out = dot_h1(relu(dot_0h(x))) + (x if same_dim else dot_01(x)).
    The inner activation is relu whatever the model's nonlinearity is."""

    def __init__(self, in_features, out_features, same_dim=False,
                 oper="wnlinear", norm=False):
        super().__init__()
        if oper == "wnlinear":
            make = lambda i, o: WeightNormalizedLinear(i, o, norm=norm)
        elif oper == "linear":
            make = Linear
        else:
            raise NotImplementedError(oper)
        self.same_dim = same_dim
        self.dot_0h = make(in_features, out_features)
        self.dot_h1 = make(out_features, out_features)
        if not same_dim:
            self.dot_01 = make(in_features, out_features)

    def forward(self, x):
        h = F.relu(self.dot_0h(x))
        out = self.dot_h1(h)
        return out + (x if self.same_dim else self.dot_01(x))



class ContextResLinear(nn.Module):
    """ResLinear with an additive context branch (reference
    models/layers.py:87-111): dot_h1(relu(dot_0h(x))) +
    dot_c1(relu(dot_0c(ctx))) + (x if same_dim else dot_01(x)), every
    product a WeightNormalizedLinear, with a bias (``use_bias``) and
    row-normalized if ``norm`` (the JAX twin's defaults: bias, no norm)."""

    def __init__(self, in_features, ctx_features, out_features, same_dim=False,
                 use_bias=True, norm=False):
        super().__init__()
        wn = lambda i: WeightNormalizedLinear(i, out_features, use_bias=use_bias,
                                              norm=norm)
        self.same_dim = same_dim
        self.dot_0h = wn(in_features)
        self.dot_h1 = wn(out_features)
        self.dot_0c = wn(ctx_features)
        self.dot_c1 = wn(out_features)
        if not same_dim:
            self.dot_01 = wn(in_features)

    def forward(self, x, ctx):
        outi = self.dot_h1(F.relu(self.dot_0h(x)))
        outc = self.dot_c1(F.relu(self.dot_0c(ctx)))
        return outi + outc + (x if self.same_dim else self.dot_01(x))


class ContextLinear(nn.Module):
    """FiLM linear (reference models/layers.py:115-144):
    (1 + cscale(ctx)) * (x @ direction) + cbias(ctx), cscale's weight
    N(0, 0.005^2) and bias-free. ``gaussian``: direction and cbias's weight
    N(0, 1) (reference models/ivae/toy.py:233-237)."""

    def __init__(self, in_features, ctx_features, out_features, gaussian=False):
        super().__init__()
        self.in_features, self.gaussian = in_features, gaussian
        self.direction = nn.Parameter(torch.empty(out_features, in_features))
        self.cscale = Linear(ctx_features, out_features, use_bias=False,
                             normal_std=0.005)
        self.cbias = Linear(ctx_features, out_features,
                            normal_std=1.0 if gaussian else None)

    def init_params(self, generator):
        _uniform_or_normal(self.direction, self.in_features, self.gaussian,
                           generator)

    def forward(self, x, ctx):
        return (1.0 + self.cscale(ctx)) * linear(x, self.direction) + self.cbias(ctx)


class ContextWeightNormalizedLinear(nn.Module):
    """FiLM with a row-normalized context scale (reference
    models/layers.py:176-215): (1 + ctx_scale * ctx @ rownorm(cscale)) *
    (x @ direction) + cbias(ctx), cscale N(0, 0.005^2); ``ctx_norm=False``
    takes (1 + ctx @ cscale) instead, ``in_norm`` row-normalizes direction.
    The defaults are the JAX twin's: in_norm False, ctx_norm True, ctx_scale
    0.1."""

    def __init__(self, in_features, ctx_features, out_features, in_norm=False,
                 ctx_norm=True, ctx_scale=0.1):
        super().__init__()
        self.in_features = in_features
        self.in_norm, self.ctx_norm, self.ctx_scale = in_norm, ctx_norm, ctx_scale
        self.direction = nn.Parameter(torch.empty(out_features, in_features))
        self.cscale = nn.Parameter(torch.empty(out_features, ctx_features))
        self.cbias = Linear(ctx_features, out_features)

    def init_params(self, generator):
        uniform_(self.direction, 1.0 / math.sqrt(self.in_features), generator)
        with torch.no_grad():
            normal_(self.cscale, generator).mul_(0.005)

    def forward(self, x, ctx):
        if self.ctx_norm:
            scale = 1.0 + self.ctx_scale * linear(ctx, _row_normalize(self.cscale))
        else:
            scale = 1.0 + linear(ctx, self.cscale)
        w = _row_normalize(self.direction) if self.in_norm else self.direction
        return scale * linear(x, w) + self.cbias(ctx)


class ContextSoftPlusLinear(nn.Module):
    """softplus(cscale(ctx)) * (x @ direction) + cbias(ctx), cscale's weight
    N(0, 0.005^2) (reference models/layers.py:219-251)."""

    def __init__(self, in_features, ctx_features, out_features):
        super().__init__()
        self.in_features = in_features
        self.direction = nn.Parameter(torch.empty(out_features, in_features))
        self.cscale = Linear(ctx_features, out_features, normal_std=0.005)
        self.cbias = Linear(ctx_features, out_features)

    def init_params(self, generator):
        uniform_(self.direction, 1.0 / math.sqrt(self.in_features), generator)

    def forward(self, x, ctx):
        return F.softplus(self.cscale(ctx)) * linear(x, self.direction) + self.cbias(ctx)


class ContextSoftPlusWeightNormalizedLinear(nn.Module):
    """softplus(ctx @ rownorm(cscale) + cscalebias) * (x @ direction) +
    cbias(ctx), cscale N(0, 1), cscalebias U(+-1/sqrt(ctx_features))
    (reference models/layers.py:286-328); ``ctx_norm=False`` takes cscale
    as it is, ``in_norm`` row-normalizes direction (the JAX twin's defaults:
    only the context path row-normalized)."""

    def __init__(self, in_features, ctx_features, out_features, in_norm=False,
                 ctx_norm=True):
        super().__init__()
        self.in_features, self.ctx_features = in_features, ctx_features
        self.in_norm, self.ctx_norm = in_norm, ctx_norm
        self.direction = nn.Parameter(torch.empty(out_features, in_features))
        self.cscale = nn.Parameter(torch.empty(out_features, ctx_features))
        self.cscalebias = nn.Parameter(torch.empty(out_features))
        self.cbias = Linear(ctx_features, out_features)

    def init_params(self, generator):
        uniform_(self.direction, 1.0 / math.sqrt(self.in_features), generator)
        normal_(self.cscale, generator)
        uniform_(self.cscalebias, 1.0 / math.sqrt(max(self.ctx_features, 1)),
                 generator)

    def forward(self, x, ctx):
        w_ctx = _row_normalize(self.cscale) if self.ctx_norm else self.cscale
        scale = F.softplus(linear(ctx, w_ctx) + self.cscalebias)
        w = _row_normalize(self.direction) if self.in_norm else self.direction
        return scale * linear(x, w) + self.cbias(ctx)


class SimplifiedBilinear(nn.Module):
    """path1(x1) + path2(x2), path2 bias-free, path1 with a bias if
    ``use_bias`` (reference models/layers.py:398-413); ``gaussian``: both
    weights N(0, 1)."""

    def __init__(self, in1_features, in2_features, out_features, gaussian=False,
                 use_bias=True):
        super().__init__()
        std = 1.0 if gaussian else None
        self.path1 = Linear(in1_features, out_features, use_bias=use_bias,
                            normal_std=std)
        self.path2 = Linear(in2_features, out_features, use_bias=False,
                            normal_std=std)

    def forward(self, x1, x2):
        return self.path1(x1) + self.path2(x2)


class WeightNormalizedSimplifiedBilinear(nn.Module):
    """x1 @ w1 + x2 @ w2 + bias, each path row-normalized if its flag says
    so (reference models/layers.py:415-455; the JAX twin's defaults:
    in1_norm False, in2_norm True, a bias); ``gaussian``: path1 and path2
    N(0, 1)."""

    def __init__(self, in1_features, in2_features, out_features, gaussian=False,
                 use_bias=True, in1_norm=False, in2_norm=True):
        super().__init__()
        self.in1_features, self.in2_features = in1_features, in2_features
        self.gaussian = gaussian
        self.in1_norm, self.in2_norm = in1_norm, in2_norm
        self.path1 = nn.Parameter(torch.empty(out_features, in1_features))
        self.path2 = nn.Parameter(torch.empty(out_features, in2_features))
        self.bias = (nn.Parameter(torch.empty(out_features))
                     if use_bias else None)

    def init_params(self, generator):
        _uniform_or_normal(self.path1, self.in1_features, self.gaussian, generator)
        _uniform_or_normal(self.path2, self.in2_features, self.gaussian, generator)
        if self.bias is not None:
            uniform_(self.bias, 1.0 / math.sqrt(self.in1_features), generator)

    def forward(self, x1, x2):
        w1 = _row_normalize(self.path1) if self.in1_norm else self.path1
        w2 = _row_normalize(self.path2) if self.in2_norm else self.path2
        y = linear(x1, w1) + linear(x2, w2)
        return y if self.bias is None else y + self.bias


class StackedWeightNormalizedSimplifiedBilinear(nn.Module):
    """fc(relu(main(x1, x2))), main a WeightNormalizedSimplifiedBilinear
    (reference models/layers.py:457-473, whose constructor passes a
    ``norm=`` keyword the layer does not take and would raise; the JAX twin
    and this port take the evident intent); ``use_bias`` is main's;
    ``gaussian``: fc's weight N(0, 1)."""

    def __init__(self, in1_features, in2_features, hid_features, out_features,
                 gaussian=False, use_bias=True):
        super().__init__()
        self.main = WeightNormalizedSimplifiedBilinear(
            in1_features, in2_features, hid_features, use_bias=use_bias)
        self.fc = Linear(hid_features, out_features,
                         normal_std=1.0 if gaussian else None)

    def forward(self, x1, x2):
        return self.fc(F.relu(self.main(x1, x2)))
