"""Toy (2-D) implicit-posterior VAE, the model of ``mlp-concat`` (JAX twin:
ardae_tpu/models/ivae/toy.py; reference models/ivae/toy.py:30-1024).

z = fc(inp_encode(x), eps): the trunk ``inp_encode`` (num_hidden_layers - 1
hidden layers and a nonlinear output) runs once per item and is broadcast
over the nz samples; ``fc`` is a ContextConcatMLP that takes the trunk
features as its input and the noise as the context of every layer, its
output weight N(0, 1). The decoder is an MLP into a Normal head whose mean
weight is N(0, 1): a Gaussian likelihood. (The N(0, 1) weights are the
twin's ``init_mode="gaussian"``, the one every registry entry uses.)
Only the ``concat`` encoder is ported, the one the registry builds; the
other eleven fusion variants wait (ROADMAP queue 1, item 2).
"""

import torch.nn as nn

from ardae_tpu_torch.nn.heads import NormalHead
from ardae_tpu_torch.nn.mlp import MLP, ContextConcatMLP


class ToyEncoder(nn.Module):
    def __init__(self, input_dim=2, noise_dim=2, h_dim=64, z_dim=2,
                 nonlinearity="tanh", num_hidden_layers=1):
        super().__init__()
        self.z_dim = z_dim
        self.inp_encode = MLP(input_dim, h_dim, h_dim, nonlinearity=nonlinearity,
                              num_hidden_layers=num_hidden_layers - 1,
                              use_nonlinearity_output=True)
        self.fc = ContextConcatMLP(h_dim, noise_dim, h_dim, z_dim,
                                   nonlinearity=nonlinearity,
                                   num_hidden_layers=num_hidden_layers)

    def forward(self, x, eps):
        """x (bsz, input_dim), eps (bsz*nz, noise_dim) -> z (bsz, nz, z_dim)."""
        bsz = x.shape[0]
        nz = eps.shape[0] // bsz
        inp = self.inp_encode(x.reshape(bsz, -1))
        inp = inp[:, None, :].expand(bsz, nz, inp.shape[-1]).reshape(bsz * nz, -1)
        return self.fc(inp, eps).reshape(bsz, nz, self.z_dim)


class ToyDecoder(nn.Module):
    """Gaussian decoder (reference :694-737)."""

    def __init__(self, input_dim=2, z_dim=2, h_dim=64, nonlinearity="tanh",
                 num_hidden_layers=1):
        super().__init__()
        self.main = MLP(z_dim, h_dim, h_dim, nonlinearity=nonlinearity,
                        num_hidden_layers=num_hidden_layers - 1,
                        use_nonlinearity_output=True)
        self.reparam = NormalHead(h_dim, input_dim, normal_mean=True)

    def forward(self, z):
        return self.reparam(self.main(z.reshape(z.shape[0], -1)))  # (mu, logvar)


class ToyIPVAE(nn.Module):
    family = "flat"
    likelihood = "gaussian"
    center_input = False

    def __init__(self, input_dim=2, noise_dim=2, h_dim=64, z_dim=2,
                 nonlinearity="tanh", num_hidden_layers=1):
        super().__init__()
        self.z_dim, self.noise_dim = z_dim, noise_dim
        self.encode = ToyEncoder(input_dim, noise_dim, h_dim, z_dim, nonlinearity,
                                 num_hidden_layers)
        self.decode = ToyDecoder(input_dim, z_dim, h_dim, nonlinearity,
                                 num_hidden_layers)

    def sample_z(self, x, eps):
        return self.encode(x, eps)

    def decode_params(self, z_flat):
        return self.decode(z_flat)
