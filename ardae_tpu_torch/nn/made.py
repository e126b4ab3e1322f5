"""Conditional MADE, the masked autoregressive conditioner of a MAF block
(JAX twin: ardae_tpu/nn/made.py; Germain et al. 2015 masks, Papamakarios
et al. 2017 usage).

Output slot ``i`` of both heads depends only on the inputs ``z_{<i}``
(strictly) and the whole context. The output heads start at zero, so a
fresh block is the identity map. The parameters keep the JAX twin's names
and (in, out) layout, so the converter maps them as they are; the masks
are fixed buffers, not parameters.
"""

import math

import numpy as np
import torch
import torch.nn as nn

from ardae_tpu_torch.nn.activations import get_nonlinear_func
from ardae_tpu_torch.nn.initializers import uniform_

# log-scale clamp: exp(a) stays in [e^-5, e^5], so the sequential inverse
# stays well conditioned (the JAX twin's A_CLAMP)
A_CLAMP = 5.0


def _degrees(input_dim, hidden_dim):
    """(deg_in [d], deg_hidden [h]) MADE degree assignment."""
    deg_in = np.arange(1, input_dim + 1)
    deg_h = (np.arange(hidden_dim) % max(1, input_dim - 1)) + 1
    return deg_in, deg_h


class ConditionalMADE(nn.Module):
    """One-hidden-layer conditional MADE: ``forward(z [..., d], ctx [...,
    c]) -> (m [..., d], a [..., d])``, ``a`` clamped to +-A_CLAMP."""

    def __init__(self, input_dim, context_dim, hidden_dim, nonlinearity="relu"):
        super().__init__()
        d, c, h = input_dim, context_dim, hidden_dim
        self.input_dim, self.context_dim = d, c
        self.afun = get_nonlinear_func(nonlinearity)
        self.w_in = nn.Parameter(torch.empty(d, h))
        self.w_ctx = nn.Parameter(torch.empty(c, h))
        self.b_h = nn.Parameter(torch.empty(h))
        self.w_m = nn.Parameter(torch.zeros(h, d))
        self.b_m = nn.Parameter(torch.zeros(d))
        self.w_a = nn.Parameter(torch.zeros(h, d))
        self.b_a = nn.Parameter(torch.zeros(d))
        deg_in, deg_h = _degrees(d, h)
        self.register_buffer("mask_h", torch.as_tensor(
            deg_h[None, :] >= deg_in[:, None], dtype=torch.float32), persistent=False)
        # strict: no output sees its own input
        self.register_buffer("mask_o", torch.as_tensor(
            deg_in[None, :] > deg_h[:, None], dtype=torch.float32), persistent=False)

    def init_params(self, generator):
        """torch-1.2 default bounds: U(+-1/sqrt(d)) and U(+-1/sqrt(c)) for
        the two input weights, U(+-1/sqrt(d + c)) for the hidden bias; zero
        heads."""
        d, c = self.input_dim, self.context_dim
        uniform_(self.w_in, 1.0 / math.sqrt(d), generator)
        uniform_(self.w_ctx, 1.0 / math.sqrt(c), generator)
        uniform_(self.b_h, 1.0 / math.sqrt(d + c), generator)
        with torch.no_grad():
            for p in (self.w_m, self.b_m, self.w_a, self.b_a):
                p.zero_()

    def forward(self, z, ctx):
        hid = self.afun(z @ (self.w_in * self.mask_h) + ctx @ self.w_ctx + self.b_h)
        m = hid @ (self.w_m * self.mask_o) + self.b_m
        a = hid @ (self.w_a * self.mask_o) + self.b_a
        return m, torch.clamp(a, -A_CLAMP, A_CLAMP)
