"""Linear-family layers of the flagship slice (JAX twin: ardae_tpu/nn/linear.py).

Weights are stored torch-style, (out_features, in_features). Weight-normalized
layers keep the torchkit parameterisation: ``direction`` (out, in), ``scale``
(out,) and ``bias`` (out,); ``norm=True`` normalises each output row over its
in-features.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ardae_tpu_torch.nn.initializers import torch_default_, xavier_


class Linear(nn.Module):
    """nn.Linear with torch-1.2 default init, or xavier-uniform weight and
    zero bias (``xavier=True``)."""

    def __init__(self, in_features, out_features, use_bias=True, xavier=False):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.xavier = xavier
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = (nn.Parameter(torch.empty(out_features))
                     if use_bias else None)

    def init_params(self, generator):
        if self.xavier:
            xavier_(self.weight, self.bias, self.in_features,
                    self.out_features, generator)
        else:
            torch_default_(self.weight, self.bias, self.in_features, generator)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


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
        d = self.direction
        if self.norm:
            d = d / torch.sqrt(torch.sum(d * d, dim=1, keepdim=True))
        y = F.linear(x, d) * self.scale
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

