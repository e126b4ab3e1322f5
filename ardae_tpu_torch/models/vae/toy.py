"""Baseline Gaussian-posterior VAE on 2-D data, the ``toy`` model (JAX twin:
ardae_tpu/models/vae/toy.py; reference models/vae/toy.py:21-244).

Encoder ``enc_main`` (MLP, num_hidden_layers - 1 hidden layers and a
nonlinear output) into ``enc_reparam`` (Normal head, default init); decoder
``dec_main`` into ``dec_reparam``: a Gaussian likelihood. Under
``init_mode="gaussian"`` (the twin's default, which every registry entry
uses) the decoder's mean weight is N(0, 1); any other mode leaves it at the
default init.
"""

import torch.nn as nn

from ardae_tpu_torch.nn.heads import NormalHead
from ardae_tpu_torch.nn.mlp import MLP


class ToyVAE(nn.Module):
    family = "gaussian_posterior"
    likelihood = "gaussian"
    center_input = False

    def __init__(self, input_dim=2, h_dim=64, z_dim=2, nonlinearity="softplus",
                 num_hidden_layers=1, init_mode="gaussian"):
        super().__init__()
        self.z_dim = z_dim
        mlp = dict(nonlinearity=nonlinearity,
                   num_hidden_layers=num_hidden_layers - 1,
                   use_nonlinearity_output=True)
        self.enc_main = MLP(input_dim, h_dim, h_dim, **mlp)
        self.enc_reparam = NormalHead(h_dim, z_dim)
        self.dec_main = MLP(z_dim, h_dim, h_dim, **mlp)
        self.dec_reparam = NormalHead(h_dim, input_dim,
                                      normal_mean=init_mode == "gaussian")

    def encode_params(self, x):
        return self.enc_reparam(self.enc_main(x.reshape(x.shape[0], -1)))

    def decode_params(self, z_flat):
        return self.dec_reparam(self.dec_main(z_flat.reshape(z_flat.shape[0], -1)))
