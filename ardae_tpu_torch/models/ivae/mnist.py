"""MNIST MLP implicit-posterior VAE, the model of ``mnist-concat`` (JAX twin:
ardae_tpu/models/ivae/mnist.py; reference models/ivae/mnist.py:38-518).

The encoder rescales the pixels to 2x - 1 and runs its MLP trunk once per
item; the first fc layer is split into ``fc_l0_inp`` (trunk features, once
per item, broadcast over the nz samples) and ``fc_l0_eps`` (noise, per
sample, no bias), the same function as one layer over the concatenation.
``fc_out``'s weight is N(0, 1) under ``init_mode="gaussian"`` (the twin's
default, which every registry entry uses), else the default init. Only the
decoder is xavier-initialised, its logit layer included (reference
:233-238 applies weight_init to decode alone).
Module names follow the flax twin, so ``convert.py`` maps one tree onto the
other.
"""

import torch.nn as nn

from ardae_tpu_torch.nn.activations import get_nonlinear_func
from ardae_tpu_torch.nn.linear import Linear
from ardae_tpu_torch.nn.mlp import MLP


class MNISTConcatEncoder(nn.Module):
    """ConcatEncoder (reference :123-165); the model builds it with
    num_hidden_layers + 1 (reference :227)."""

    def __init__(self, input_dim=784, noise_dim=100, h_dim=300, z_dim=32,
                 nonlinearity="softplus", num_hidden_layers=2,
                 init_mode="gaussian"):
        super().__init__()
        self.h_dim, self.z_dim = h_dim, z_dim
        self.afun = get_nonlinear_func(nonlinearity)
        self.inp_encode = MLP(input_dim, h_dim, h_dim, nonlinearity=nonlinearity,
                              num_hidden_layers=num_hidden_layers,
                              use_nonlinearity_output=True)
        self.fc_l0_inp = Linear(h_dim, h_dim)
        self.fc_l0_eps = Linear(noise_dim, h_dim, use_bias=False)
        self.fc_out = Linear(h_dim, z_dim,
                             normal_std=1.0 if init_mode == "gaussian" else None)

    def forward(self, x, eps):
        """x (bsz, D), eps (bsz*nz, noise_dim) -> z (bsz, nz, z_dim)."""
        bsz = x.shape[0]
        nz = eps.shape[0] // bsz
        h_inp = self.fc_l0_inp(self.inp_encode(2.0 * x.reshape(bsz, -1) - 1.0))
        h = h_inp[:, None, :] + self.fc_l0_eps(eps).reshape(bsz, nz, self.h_dim)
        z = self.fc_out(self.afun(h.reshape(bsz * nz, self.h_dim)))
        return z.reshape(bsz, nz, self.z_dim)


class MNISTDecoder(nn.Module):
    """Bernoulli MLP decoder (reference :167-199), xavier-initialised."""

    def __init__(self, input_dim=784, z_dim=32, h_dim=300,
                 nonlinearity="softplus", num_hidden_layers=1):
        super().__init__()
        self.main = MLP(z_dim, h_dim, h_dim, nonlinearity=nonlinearity,
                        num_hidden_layers=num_hidden_layers,
                        use_nonlinearity_output=True, xavier=True)
        self.reparam_logit = Linear(h_dim, input_dim, xavier=True)

    def forward(self, z):
        return (self.reparam_logit(self.main(z.reshape(z.shape[0], -1))),)


class MNISTIPVAE(nn.Module):
    family = "flat"
    likelihood = "bernoulli"
    center_input = True

    def __init__(self, input_dim=784, noise_dim=100, h_dim=300, z_dim=32,
                 nonlinearity="softplus", num_hidden_layers=1,
                 init_mode="gaussian"):
        super().__init__()
        self.z_dim, self.noise_dim = z_dim, noise_dim
        self.encode = MNISTConcatEncoder(input_dim, noise_dim, h_dim, z_dim,
                                         nonlinearity, num_hidden_layers + 1,
                                         init_mode)
        self.decode = MNISTDecoder(input_dim, z_dim, h_dim, nonlinearity,
                                   num_hidden_layers)

    def sample_z(self, x, eps):
        return self.encode(x, eps)

    def decode_params(self, z_flat):
        return self.decode(z_flat)
