"""Residual-conv implicit-posterior VAE (JAX twin:
ardae_tpu/models/ivae/resconv.py). Only the ``res-wn-mlp`` fc head of the
flagship ``resconvct-res`` model is ported; the other four wait (ROADMAP
queue 1, slice 2)."""

import torch
import torch.nn as nn

from ardae_tpu_torch.models.vae.resconv import ResConvDecoder, ResConvTrunk
from ardae_tpu_torch.nn.mlp import ResMLP

FC_TYPES = ("res-wn-mlp",)


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
            raise NotImplementedError(
                f"resconv fc head {enc_type!r} is not ported yet (ROADMAP "
                "queue 1, slice 2)")
        if num_hidden_layers < 1:
            raise ValueError("num_hidden_layers must be >= 1")
        self.z_dim, self.noise_dim = z_dim, noise_dim
        self.trunk = ResConvTrunk(c_dim, nonlinearity, do_center)
        self.fc = ResMLP(c_dim + noise_dim, h_dim, z_dim,
                         nonlinearity=nonlinearity,
                         num_hidden_layers=num_hidden_layers, layer="wnlinear")
        self.decode = ResConvDecoder(z_dim, c_dim, nonlinearity, do_m5bias)

    def sample_z(self, x, eps):
        """x (bsz, 784), eps (bsz*nz, noise_dim) -> z (bsz, nz, z_dim)."""
        bsz = x.shape[0]
        nz = eps.shape[0] // bsz
        inp = self.trunk(x)
        h = torch.cat([inp[:, None, :].expand(bsz, nz, inp.shape[-1]),
                       eps.reshape(bsz, nz, -1)], dim=-1)
        z = self.fc(h.reshape(bsz * nz, -1))
        return z.reshape(bsz, nz, self.z_dim)

    def decode_params(self, z_flat):
        return self.decode(z_flat)
