"""MNIST conv implicit-posterior VAE, the model of the implicit-conv line
(JAX twin: ardae_tpu/models/ivae/conv.py; reference models/ivae/conv.py:
562-823).

The conv trunk runs once per item; its fc4 layer is split into ``fc4_inp``
(trunk features, once per item, broadcast over the nz samples) and
``fc4_eps`` (noise, per sample, no bias): the same function as one layer
over the concatenation. The decoder is the conv VAE's deconv decoder.
``do_xavier`` (the JAX twin's default True, reference :682-686, the only
value the drivers use) xavier-initialises the whole model; False leaves
every layer at the torch default.
"""

import torch.nn as nn

from ardae_tpu_torch.models.vae.conv import ConvDecoder, ConvEncoderTrunk
from ardae_tpu_torch.nn.activations import get_nonlinear_func
from ardae_tpu_torch.nn.linear import Linear

FC4 = 800


class ConvIPVAE(nn.Module):
    family = "flat"
    likelihood = "bernoulli"
    center_input = True

    def __init__(self, input_height=28, input_channels=1, z_dim=32,
                 noise_dim=100, nonlinearity="softplus", do_xavier=True):
        super().__init__()
        self.z_dim, self.noise_dim = z_dim, noise_dim
        self.afun = get_nonlinear_func(nonlinearity)
        xav = do_xavier
        self.trunk = ConvEncoderTrunk(input_height, input_channels,
                                      nonlinearity, xavier=xav)
        self.fc4_inp = Linear(32 * self.trunk.s ** 2, FC4, xavier=xav)
        self.fc4_eps = Linear(noise_dim, FC4, use_bias=False, xavier=xav)
        self.fc5 = Linear(FC4, z_dim, xavier=xav)
        self.decode = ConvDecoder(z_dim, input_height, input_channels,
                                  nonlinearity, xavier=xav)

    def sample_z(self, x, eps):
        """x (bsz, C*H*W), eps (bsz*nz, noise_dim) -> z (bsz, nz, z_dim)."""
        bsz = x.shape[0]
        nz = eps.shape[0] // bsz
        h_inp = self.fc4_inp(self.trunk(x))                  # once per item
        h4 = h_inp[:, None, :] + self.fc4_eps(eps).reshape(bsz, nz, FC4)
        z = self.fc5(self.afun(h4.reshape(bsz * nz, FC4)))
        return z.reshape(bsz, nz, self.z_dim)

    def decode_params(self, z_flat):
        return self.decode(z_flat)
