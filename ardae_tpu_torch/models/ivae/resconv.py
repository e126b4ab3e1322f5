"""Residual-conv implicit-posterior VAE (JAX twin:
ardae_tpu/models/ivae/resconv.py).

The resconv trunk gives a c_dim context per item, concatenated with each
noise draw and fused through one of five fc heads (reference :529-546):

  * ``mlp``: MLP(c+n -> h x num_hidden_layers -> z), ``fc``;
  * ``res-wn-mlp`` / ``res-mlp``: ResMLP(c+n -> h x num_hidden_layers ->
    z) of weight-normalised (norm=False) or plain linear blocks, ``fc``;
  * ``res-wn-mlp-lin`` / ``res-mlp-lin``: ResMLP(c+n -> h x
    (num_hidden_layers - 1) -> h, output nonlinearity), ``fc_res``, then a
    Linear(h -> z), ``fc_lin``. At one layer ``fc_res`` is a single
    ResLinear block.

The decoder is the resconv VAE decoder.
"""

import torch
import torch.nn as nn

from ardae_tpu_torch.models.vae.resconv import ResConvDecoder, ResConvTrunk
from ardae_tpu_torch.nn.linear import Linear
from ardae_tpu_torch.nn.mlp import MLP, ResMLP

FC_TYPES = ("mlp", "res-wn-mlp", "res-mlp", "res-wn-mlp-lin", "res-mlp-lin")


class ResConvIPVAE(nn.Module):
    family = "flat"
    likelihood = "bernoulli"
    center_input = True

    def __init__(self, input_height=28, input_channels=1, z_dim=32,
                 noise_dim=100, c_dim=512, h_dim=800, num_hidden_layers=1,
                 nonlinearity="elu", do_center=False, do_m5bias=False,
                 enc_type="res-wn-mlp"):
        super().__init__()
        if input_height != 28 or input_channels != 1:
            raise ValueError("ResConvIPVAE takes 28x28x1 images")
        if enc_type not in FC_TYPES:
            raise ValueError(f"unknown resconv fc head {enc_type!r}")
        if num_hidden_layers < 1:
            raise ValueError("num_hidden_layers must be >= 1")
        self.z_dim, self.noise_dim = z_dim, noise_dim
        self.enc_type = enc_type
        self.trunk = ResConvTrunk(c_dim, nonlinearity, do_center)
        d_in = c_dim + noise_dim
        layer = "wnlinear" if enc_type.startswith("res-wn") else "linear"
        if enc_type == "mlp":
            self.fc = MLP(d_in, h_dim, z_dim, nonlinearity=nonlinearity,
                          num_hidden_layers=num_hidden_layers)
        elif enc_type.endswith("-lin"):
            self.fc_res = ResMLP(d_in, h_dim, h_dim, nonlinearity=nonlinearity,
                                 num_hidden_layers=num_hidden_layers - 1,
                                 use_nonlinearity_output=True, layer=layer)
            self.fc_lin = Linear(h_dim, z_dim)
        else:
            self.fc = ResMLP(d_in, h_dim, z_dim, nonlinearity=nonlinearity,
                             num_hidden_layers=num_hidden_layers, layer=layer)
        self.decode = ResConvDecoder(z_dim, c_dim, nonlinearity, do_m5bias)

    def encode_cat(self, h):
        """The fc head over concatenated [trunk context, noise] rows."""
        if self.enc_type.endswith("-lin"):
            return self.fc_lin(self.fc_res(h))
        return self.fc(h)

    def sample_z(self, x, eps):
        """x (bsz, 784), eps (bsz*nz, noise_dim) -> z (bsz, nz, z_dim)."""
        bsz = x.shape[0]
        nz = eps.shape[0] // bsz
        inp = self.trunk(x)
        h = torch.cat([inp[:, None, :].expand(bsz, nz, inp.shape[-1]),
                       eps.reshape(bsz, nz, -1)], dim=-1)
        z = self.encode_cat(h.reshape(bsz * nz, -1))
        return z.reshape(bsz, nz, self.z_dim)

    def decode_params(self, z_flat):
        return self.decode(z_flat)
