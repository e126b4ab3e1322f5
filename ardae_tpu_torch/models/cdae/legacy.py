"""Legacy reconstruction-style DAEs (JAX twin: ardae_tpu/models/cdae/legacy.py;
reference models/dae/mlp.py:21-193).

score = (recon(x) - x) / sigma^2; loss = mse(recon(x + sigma*eps), x). The
reference registers them but no driver builds them: both drivers refuse
``--cdae mlp``, and ``build_cdae("mlp")`` raises, as in the JAX package.
"""

import torch
import torch.nn as nn

from ardae_tpu_torch.models.cdae.cardae import dsm_noise
from ardae_tpu_torch.nn.mlp import MLP


class MLPDAE(nn.Module):
    """Plain reconstructing DAE (reference models/dae/mlp.py:21-82)."""

    def __init__(self, input_dim, h_dim=1000, num_hidden_layers=1,
                 nonlinearity="tanh"):
        super().__init__()
        self.main = MLP(input_dim, h_dim, input_dim, nonlinearity=nonlinearity,
                        num_hidden_layers=num_hidden_layers)

    def forward(self, x):
        return self.main(x)


class MLPCDAE(nn.Module):
    """Conditional reconstructing DAE (reference models/dae/mlp.py:85-193):
    dae(cat(inp_encode(x) or x, ctx_encode(ctx) or ctx))."""

    def __init__(self, input_dim, context_dim, h_dim=128, num_hidden_layers=1,
                 nonlinearity="tanh", enc_input=False, enc_ctx=True):
        super().__init__()
        self.enc_input, self.enc_ctx = enc_input, enc_ctx
        enc = dict(nonlinearity=nonlinearity,
                   num_hidden_layers=num_hidden_layers - 1,
                   use_nonlinearity_output=True)
        if enc_ctx:
            self.ctx_encode = MLP(context_dim, h_dim, h_dim, **enc)
        if enc_input:
            self.inp_encode = MLP(input_dim, h_dim, h_dim, **enc)
        width = ((h_dim if enc_input else input_dim)
                 + (h_dim if enc_ctx else context_dim))
        self.dae = MLP(width, h_dim, input_dim, nonlinearity=nonlinearity,
                       num_hidden_layers=num_hidden_layers)

    def forward(self, x, ctx):
        inp = self.inp_encode(x) if self.enc_input else x
        c = self.ctx_encode(ctx) if self.enc_ctx else ctx
        return self.dae(torch.cat([inp, c], dim=-1))


def _recon(module, x, ctx):
    return module(x) if ctx is None else module(x, ctx)


def legacy_dae_loss(module, x, std, ctx=None, generator=None, eps=None):
    """mse(recon(x + std*eps), x); ``eps`` injected or drawn from
    ``generator``."""
    eps = dsm_noise(x.shape, generator, eps, device=x.device)
    return torch.mean((_recon(module, x + std * eps, ctx) - x) ** 2)


def legacy_dae_score(module, x, std, ctx=None):
    """(recon(x) - x) / std^2 (reference models/dae/mlp.py:72-82)."""
    return (_recon(module, x, ctx) - x) / (std ** 2)
