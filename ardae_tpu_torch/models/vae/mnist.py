"""Baseline MNIST MLP VAE (JAX twin: ardae_tpu/models/vae/mnist.py;
reference models/vae/mnist.py:28-255).

Encoder: 2x - 1, ``enc_main`` = MLP(D -> h x (n_layers - 1) -> h, output
nonlinearity), then ``enc_reparam`` (Normal head). Decoder: ``dec_main``,
the same MLP from z, then ``dec_logit`` (Bernoulli logits). The JAX twin's
``do_xavier`` / ``do_m5bias`` options are not ported: every registry passes
False for both.
"""

import torch.nn as nn

from ardae_tpu_torch.nn.heads import NormalHead
from ardae_tpu_torch.nn.linear import Linear
from ardae_tpu_torch.nn.mlp import MLP


class MNISTVAE(nn.Module):
    family = "gaussian_posterior"
    likelihood = "bernoulli"
    center_input = True

    def __init__(self, input_dim=784, h_dim=300, z_dim=32,
                 nonlinearity="softplus", num_hidden_layers=2):
        super().__init__()
        self.z_dim = z_dim
        mlp = dict(nonlinearity=nonlinearity,
                   num_hidden_layers=num_hidden_layers - 1,
                   use_nonlinearity_output=True)
        self.enc_main = MLP(input_dim, h_dim, h_dim, **mlp)
        self.enc_reparam = NormalHead(h_dim, z_dim)
        self.dec_main = MLP(z_dim, h_dim, h_dim, **mlp)
        self.dec_logit = Linear(h_dim, input_dim)

    def encode_params(self, x):
        return self.enc_reparam(self.enc_main(2.0 * x.reshape(x.shape[0], -1) - 1.0))

    def decode_params(self, z_flat):
        h = self.dec_main(z_flat.reshape(z_flat.shape[0], -1))
        return (self.dec_logit(h),)
