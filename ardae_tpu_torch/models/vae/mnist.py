"""Baseline MNIST MLP VAE (JAX twin: ardae_tpu/models/vae/mnist.py;
reference models/vae/mnist.py:28-255).

Encoder: 2x - 1, ``enc_main`` = MLP(D -> h x (n_layers - 1) -> h, output
nonlinearity), then ``enc_reparam`` (Normal head). Decoder: ``dec_main``,
the same MLP from z, then ``dec_logit`` (Bernoulli logits). ``do_xavier``
(reference :125-129) makes every layer xavier-uniform with zero biases and
splits the head into the plain linears ``enc_mean`` / ``enc_logvar``, as
the JAX twin does; ``do_m5bias`` starts ``dec_logit``'s bias at -5. Both
default False, the value every registry passes.
"""

import torch
import torch.nn as nn

from ardae_tpu_torch.nn.heads import NormalHead
from ardae_tpu_torch.nn.linear import Linear
from ardae_tpu_torch.nn.mlp import MLP


class _M5BiasLinear(Linear):
    """``Linear`` whose bias starts at -5 (the reference's do_m5bias)."""

    def init_params(self, generator):
        super().init_params(generator)
        with torch.no_grad():
            self.bias.fill_(-5.0)


class MNISTVAE(nn.Module):
    family = "gaussian_posterior"
    likelihood = "bernoulli"
    center_input = True

    def __init__(self, input_dim=784, h_dim=300, z_dim=32,
                 nonlinearity="softplus", num_hidden_layers=2, do_xavier=False,
                 do_m5bias=False):
        super().__init__()
        self.z_dim, self.do_xavier = z_dim, do_xavier
        mlp = dict(nonlinearity=nonlinearity,
                   num_hidden_layers=num_hidden_layers - 1,
                   use_nonlinearity_output=True, xavier=do_xavier)
        self.enc_main = MLP(input_dim, h_dim, h_dim, **mlp)
        if do_xavier:
            self.enc_mean = Linear(h_dim, z_dim, xavier=True)
            self.enc_logvar = Linear(h_dim, z_dim, xavier=True)
        else:
            self.enc_reparam = NormalHead(h_dim, z_dim)
        self.dec_main = MLP(z_dim, h_dim, h_dim, **mlp)
        self.dec_logit = (_M5BiasLinear if do_m5bias else Linear)(
            h_dim, input_dim, xavier=do_xavier)

    def encode_params(self, x):
        h = self.enc_main(2.0 * x.reshape(x.shape[0], -1) - 1.0)
        if self.do_xavier:
            return self.enc_mean(h), self.enc_logvar(h)
        return self.enc_reparam(h)

    def decode_params(self, z_flat):
        h = self.dec_main(z_flat.reshape(z_flat.shape[0], -1))
        return (self.dec_logit(h),)
