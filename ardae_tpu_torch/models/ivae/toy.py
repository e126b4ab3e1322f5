"""Toy (2-D) implicit-posterior VAE with the thirteen encoder fusions (JAX
twin: ardae_tpu/models/ivae/toy.py; reference models/ivae/toy.py:30-1024).

z = fc(inp_encode(x), eps): the trunk ``inp_encode`` (num_hidden_layers - 1
hidden layers and a nonlinear output; weight-normalized for
``weightnorm``) runs once per item and is broadcast over the nz samples;
``fc`` fuses the trunk features with the noise, as ``enc_type`` says:
  * ``simple``, ``weightnorm``: an MLP (WNMLP) of cat(features, noise);
  * ``scale-nosinp``, ``softplus-weightnorm-scale-nosinp``, ``res``: a
    context MLP whose input is the noise and whose context the features;
  * the others, ``concat`` among them (the one every registry name
    builds): a context MLP whose input is the features and whose context
    the noise (``stacked-weightnorm-bilinear`` with one hidden layer
    fewer, each layer two deep).
The decoder is an MLP into a Normal head: a Gaussian likelihood. Under
``init_mode="gaussian"`` (the JAX twin's default, and the only mode any
registry name or script uses) the encoder's output layer and the decoder's
mean weight are drawn from N(0, 1) where the reference's reset_parameters
does so; any other mode leaves every layer at its default init.
"""

import torch
import torch.nn as nn

from ardae_tpu_torch.nn.heads import NormalHead
from ardae_tpu_torch.nn.mlp import (
    MLP,
    WNMLP,
    ContextBilinearMLP,
    ContextConcatMLP,
    ContextResMLP,
    ContextScaleMLP,
    ContextSPScaleMLP,
    ContextSPWNScaleMLP,
    ContextSWNBilinearMLP,
    ContextWNBilinearMLP,
    ContextWNScaleMLP,
)

ENC_TYPES = (
    "simple",
    "weightnorm",
    "concat",
    "scale-inpnos",
    "weightnorm-scale-inpnos",
    "softplus-scale-inpnos",
    "softplus-weightnorm-scale-inpnos",
    "scale-nosinp",
    "softplus-weightnorm-scale-nosinp",
    "bilinear",
    "weightnorm-bilinear",
    "stacked-weightnorm-bilinear",
    "res",
)
# fusions that take cat(features, noise), and those that take the noise as
# their input and the features as their context
_CAT = ("simple", "weightnorm")
_NOISE_IN = ("scale-nosinp", "softplus-weightnorm-scale-nosinp", "res")
# the context MLP of each other fusion
_CONTEXT_MLP = {
    "concat": ContextConcatMLP,
    "scale-inpnos": ContextScaleMLP,
    "scale-nosinp": ContextScaleMLP,
    "weightnorm-scale-inpnos": ContextWNScaleMLP,
    "softplus-scale-inpnos": ContextSPScaleMLP,
    "softplus-weightnorm-scale-inpnos": ContextSPWNScaleMLP,
    "softplus-weightnorm-scale-nosinp": ContextSPWNScaleMLP,
    "bilinear": ContextBilinearMLP,
    "weightnorm-bilinear": ContextWNBilinearMLP,
    "stacked-weightnorm-bilinear": ContextSWNBilinearMLP,
    "res": ContextResMLP,
}


class ToyEncoder(nn.Module):
    def __init__(self, input_dim=2, noise_dim=2, h_dim=64, z_dim=2,
                 nonlinearity="tanh", num_hidden_layers=1, enc_type="concat",
                 init_mode="gaussian"):
        super().__init__()
        if enc_type not in ENC_TYPES:
            raise ValueError(f"unknown toy encoder {enc_type!r}: one of {ENC_TYPES}")
        self.z_dim, self.enc_type = z_dim, enc_type
        gauss = init_mode == "gaussian"
        trunk = WNMLP if enc_type == "weightnorm" else MLP
        self.inp_encode = trunk(input_dim, h_dim, h_dim, nonlinearity=nonlinearity,
                                num_hidden_layers=num_hidden_layers - 1,
                                use_nonlinearity_output=True)
        fc = dict(nonlinearity=nonlinearity, num_hidden_layers=num_hidden_layers)
        if enc_type == "simple":
            self.fc = MLP(h_dim + noise_dim, h_dim, z_dim, gaussian_out_init=gauss,
                          **fc)
        elif enc_type == "weightnorm":
            # the reference's WeightNormalizedEncoder.reset_parameters names
            # a nonexistent fc2 (models/ivae/toy.py:686-687); the default WN
            # init stands, as in the JAX twin
            self.fc = WNMLP(h_dim + noise_dim, h_dim, z_dim, **fc)
        else:
            if enc_type == "stacked-weightnorm-bilinear":
                fc["num_hidden_layers"] = num_hidden_layers - 1
            if enc_type != "res":   # ContextResMLP draws nothing from N(0, 1)
                fc["gaussian_out_init"] = gauss
            in_dim, ctx_dim = ((noise_dim, h_dim) if enc_type in _NOISE_IN
                               else (h_dim, noise_dim))
            self.fc = _CONTEXT_MLP[enc_type](in_dim, ctx_dim, h_dim, z_dim, **fc)

    def forward_all(self, inp, nos):
        """Fuse the flattened features (n, h) with the scaled noise (n, noise)."""
        if self.enc_type in _CAT:
            return self.fc(torch.cat([inp, nos], dim=1))
        if self.enc_type in _NOISE_IN:
            return self.fc(nos, inp)
        return self.fc(inp, nos)

    def forward(self, x, eps):
        """x (bsz, input_dim), eps (bsz*nz, noise_dim) -> z (bsz, nz, z_dim)."""
        bsz = x.shape[0]
        nz = eps.shape[0] // bsz
        inp = self.inp_encode(x.reshape(bsz, -1))
        inp = inp[:, None, :].expand(bsz, nz, inp.shape[-1]).reshape(bsz * nz, -1)
        return self.forward_all(inp, eps).reshape(bsz, nz, self.z_dim)


class ToyDecoder(nn.Module):
    """Gaussian decoder (reference :694-737); the mean weight N(0, 1) under
    ``init_mode="gaussian"``."""

    def __init__(self, input_dim=2, z_dim=2, h_dim=64, nonlinearity="tanh",
                 num_hidden_layers=1, init_mode="gaussian"):
        super().__init__()
        self.main = MLP(z_dim, h_dim, h_dim, nonlinearity=nonlinearity,
                        num_hidden_layers=num_hidden_layers - 1,
                        use_nonlinearity_output=True)
        self.reparam = NormalHead(h_dim, input_dim,
                                  normal_mean=init_mode == "gaussian")

    def forward(self, z):
        return self.reparam(self.main(z.reshape(z.shape[0], -1)))  # (mu, logvar)


class ToyIPVAE(nn.Module):
    family = "flat"
    likelihood = "gaussian"
    center_input = False

    def __init__(self, input_dim=2, noise_dim=2, h_dim=64, z_dim=2,
                 nonlinearity="tanh", num_hidden_layers=1, enc_type="concat",
                 init_mode="gaussian"):
        super().__init__()
        self.z_dim, self.noise_dim = z_dim, noise_dim
        self.encode = ToyEncoder(input_dim, noise_dim, h_dim, z_dim, nonlinearity,
                                 num_hidden_layers, enc_type, init_mode)
        self.decode = ToyDecoder(input_dim, z_dim, h_dim, nonlinearity,
                                 num_hidden_layers, init_mode)

    def sample_z(self, x, eps):
        return self.encode(x, eps)

    def decode_params(self, z_flat):
        return self.decode(z_flat)
