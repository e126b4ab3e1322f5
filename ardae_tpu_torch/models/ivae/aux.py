"""Hierarchical ("aux") implicit-posterior VAEs (JAX twin:
ardae_tpu/models/ivae/aux.py; reference models/ivae/aux*.py).

q(z0|x) is a reparameterised Gaussian, then q(z|x,z0) a second one; both
draws are scaled by the external ``noise_scale`` (the reference's ``_std``:
None means 1, 0.0 gives the deterministic encoding). The prior loss stays
the standard-normal energy; the entropy gradient comes from the CDAE.

Aux API (``family = "aux"``):
  sample_z(x, (eps0, eps), noise_scale)     -> z (bsz, nz, z_dim)
  hidden_feats(x, (eps0, eps), noise_scale) -> the hidden1a context (nz 1)
  decode_params(z_flat)

eps0 is (bsz*nz, noise_dim) and eps (bsz*nz, z_dim), as every MNIST
variant of the reference draws them (the toy reference's quirky
(bsz*nz, nz, zdim) draw is the same law at nz 1, the drivers' default).

Variants: ``ToyAuxIPVAE`` (auxmlp: MLP towers, Gaussian decoder, its mean
weight N(0, 1) under ``init_mode="gaussian"``), ``MNISTAuxIPVAE`` (auxmnist:
MLP towers, Bernoulli decoder, every layer xavier under ``do_xavier``),
``MNISTConvAuxIPVAE`` (auxconv: two conv towers, each with its own trunk,
all xavier under ``do_xavier``; context cat(h0, h)) and
``MNISTResConvAuxIPVAE`` (auxresconv(ct): one shared resconv trunk, spm4
logvar clamp on both heads; ``clipped=True`` is auxresconv2, the -clip
names: no clamp and a +1 floor on the z0 std). The MLP models'
``clip_z0_logvar`` / ``clip_z_logvar`` clip their z0 and z heads (the
drivers pass ``none``). Every option takes the JAX twin's name and default.
"""

import torch
import torch.nn as nn

from ardae_tpu_torch.models.ivae.mnist import MNISTDecoder
from ardae_tpu_torch.models.ivae.toy import ToyDecoder
from ardae_tpu_torch.models.vae.conv import ConvDecoder, ConvEncoderTrunk
from ardae_tpu_torch.models.vae.resconv import ResConvDecoder, ResConvTrunk
from ardae_tpu_torch.nn.activations import get_nonlinear_func
from ardae_tpu_torch.nn.heads import NormalHead
from ardae_tpu_torch.nn.linear import Linear
from ardae_tpu_torch.nn.mlp import MLP

CONV_FC = 800  # the conv towers' fc width (reference models/ivae/auxconv.py)


def scaled_sample(mu, logvar, eps, scale, min_std=0.0):
    """mu + (scale * exp(logvar / 2) + min_std) * eps, scale None meaning 1
    (reference auxresconv2.py sample_gaussian with min_std)."""
    s = 1.0 if scale is None else scale
    return mu + (s * torch.exp(0.5 * logvar) + min_std) * eps


def bcast_rows(t, bsz, nz):
    """(bsz, d) -> (bsz*nz, d), each item's row repeated nz times."""
    return t[:, None, :].expand(bsz, nz, t.shape[-1]).reshape(bsz * nz, -1)


class _AuxBase(nn.Module):
    """The shared sampler: a subclass defines ``aux_params(feats)`` ->
    (mu0, logvar0, h0) and ``main_params(feats_rows, z0)`` -> (mu, logvar,
    h), and may override ``trunk_feats`` (default: x as it comes)."""

    family = "aux"
    z0_min_std = 0.0

    def trunk_feats(self, x):
        return x.reshape(x.shape[0], -1)

    def _sample_all(self, x, eps, noise_scale):
        eps0, eps1 = eps
        bsz = x.shape[0]
        nz = eps0.shape[0] // bsz
        feats = self.trunk_feats(x)
        mu0, lv0, h0 = self.aux_params(feats)
        z0 = scaled_sample(bcast_rows(mu0, bsz, nz), bcast_rows(lv0, bsz, nz),
                           eps0, noise_scale, self.z0_min_std)
        mu, lv, h = self.main_params(bcast_rows(feats, bsz, nz), z0)
        z = scaled_sample(mu, lv, eps1, noise_scale)
        return z.reshape(bsz, nz, -1), h0, h

    def sample_z(self, x, eps, noise_scale=None):
        return self._sample_all(x, eps, noise_scale)[0]

    def hidden_feats(self, x, eps, noise_scale=None):
        """The hidden1a context (reference forward_hidden; nz must be 1)."""
        _, h0, h = self._sample_all(x, eps, noise_scale)
        return torch.cat([h0, h], dim=1) if self.hidden_mode == "cat" else h

    def decode_params(self, z_flat):
        return self.decode(z_flat)


class _MLPAuxIPVAE(_AuxBase):
    """MLP towers: ``aux_main`` (x -> h) into ``aux_reparam`` (z0), and
    ``enc_fc`` (cat(x, z0) -> h) into ``enc_reparam`` (z), each tower
    num_hidden_layers - 1 hidden layers and a nonlinear output."""

    hidden_mode = "cat"

    def __init__(self, input_dim, noise_dim, h_dim, z_dim, nonlinearity,
                 num_hidden_layers, xavier, clip_z0_logvar, clip_z_logvar):
        super().__init__()
        self.z_dim, self.noise_dim = z_dim, noise_dim
        mlp = dict(nonlinearity=nonlinearity,
                   num_hidden_layers=num_hidden_layers - 1,
                   use_nonlinearity_output=True, xavier=xavier)
        self.aux_main = MLP(input_dim, h_dim, h_dim, **mlp)
        self.aux_reparam = NormalHead(h_dim, noise_dim, clip=clip_z0_logvar,
                                      xavier=xavier)
        self.enc_fc = MLP(input_dim + noise_dim, h_dim, h_dim, **mlp)
        self.enc_reparam = NormalHead(h_dim, z_dim, clip=clip_z_logvar,
                                      xavier=xavier)

    def aux_params(self, feats):
        h = self.aux_main(feats)
        return (*self.aux_reparam(h), h)

    def main_params(self, feats_rows, z0):
        h = self.enc_fc(torch.cat([feats_rows, z0], dim=1))
        return (*self.enc_reparam(h), h)


class ToyAuxIPVAE(_MLPAuxIPVAE):
    """auxmlp (reference models/ivae/auxtoy.py:46-430): towers over the raw
    input, the toy Gaussian decoder."""

    likelihood = "gaussian"
    center_input = False

    def __init__(self, input_dim=2, noise_dim=2, h_dim=64, z_dim=2,
                 nonlinearity="tanh", num_hidden_layers=1, init_mode="gaussian",
                 clip_z0_logvar=None, clip_z_logvar=None):
        super().__init__(input_dim, noise_dim, h_dim, z_dim, nonlinearity,
                         num_hidden_layers, False, clip_z0_logvar, clip_z_logvar)
        self.decode = ToyDecoder(input_dim, z_dim, h_dim, nonlinearity,
                                 num_hidden_layers, init_mode)


class MNISTAuxIPVAE(_MLPAuxIPVAE):
    """auxmnist (reference models/ivae/auxmnist.py:47-428): towers over 2x
    - 1, xavier under ``do_xavier`` (reference :172-176), the MNIST decoder
    (always xavier) with num_hidden_layers - 1 hidden layers."""

    likelihood = "bernoulli"
    center_input = True

    def __init__(self, input_dim=784, noise_dim=100, h_dim=300, z_dim=32,
                 nonlinearity="softplus", num_hidden_layers=2,
                 clip_z0_logvar=None, clip_z_logvar=None, do_xavier=True):
        super().__init__(input_dim, noise_dim, h_dim, z_dim, nonlinearity,
                         num_hidden_layers, do_xavier, clip_z0_logvar,
                         clip_z_logvar)
        self.decode = MNISTDecoder(input_dim, z_dim, h_dim, nonlinearity,
                                   num_hidden_layers - 1)

    def trunk_feats(self, x):
        return 2.0 * x.reshape(x.shape[0], -1) - 1.0


class MNISTConvAuxIPVAE(_AuxBase):
    """auxconv (reference models/ivae/auxconv.py:50-423): two conv towers,
    each running its own trunk on x, all xavier under ``do_xavier``; the
    hidden1a context is cat(h0, h) of the two 800-wide fc features."""

    likelihood = "bernoulli"
    center_input = True
    hidden_mode = "cat"

    def __init__(self, input_height=28, input_channels=1, z0_dim=100, z_dim=32,
                 nonlinearity="softplus", do_xavier=True):
        super().__init__()
        self.z_dim, self.noise_dim = z_dim, z0_dim
        self.afun = get_nonlinear_func(nonlinearity)
        xav = do_xavier
        trunk = dict(input_height=input_height, input_channels=input_channels,
                     nonlinearity=nonlinearity, xavier=xav)
        self.aux_trunk = ConvEncoderTrunk(**trunk)
        feat = 32 * self.aux_trunk.s ** 2
        self.aux_fc = Linear(feat, CONV_FC, xavier=xav)
        self.aux_reparam = NormalHead(CONV_FC, z0_dim, xavier=xav)
        self.enc_trunk = ConvEncoderTrunk(**trunk)
        self.enc_fc = Linear(feat + z0_dim, CONV_FC, xavier=xav)
        self.enc_reparam = NormalHead(CONV_FC, z_dim, xavier=xav)
        self.decode = ConvDecoder(z_dim, input_height, input_channels,
                                  nonlinearity, xavier=xav)

    def _sample_all(self, x, eps, noise_scale):
        # each tower runs its own trunk on x, once per item
        eps0, eps1 = eps
        bsz = x.shape[0]
        nz = eps0.shape[0] // bsz
        h0 = self.afun(self.aux_fc(self.aux_trunk(x)))
        mu0, lv0 = self.aux_reparam(h0)
        z0 = scaled_sample(bcast_rows(mu0, bsz, nz), bcast_rows(lv0, bsz, nz),
                           eps0, noise_scale)
        trunk = bcast_rows(self.enc_trunk(x), bsz, nz)
        h = self.afun(self.enc_fc(torch.cat([trunk, z0], dim=1)))
        mu, lv = self.enc_reparam(h)
        z = scaled_sample(mu, lv, eps1, noise_scale)
        return z.reshape(bsz, nz, -1), h0, h


class MNISTResConvAuxIPVAE(_AuxBase):
    """auxresconv(ct) (reference models/ivae/auxresconv.py:48-411) and,
    with ``clipped``, auxresconv2 (the -clip names). One shared resconv
    trunk (c_dim) feeds the z0 head directly and, through ``enc_fc`` over
    cat(trunk, z0), the z head; the hidden1a context is that main feature h
    (reference :126-132)."""

    likelihood = "bernoulli"
    center_input = True
    hidden_mode = "h"

    def __init__(self, input_height=28, input_channels=1, z0_dim=100, z_dim=32,
                 c_dim=450, nonlinearity="elu", do_center=False, clipped=False):
        super().__init__()
        if input_height != 28 or input_channels != 1:
            raise ValueError("MNISTResConvAuxIPVAE takes 28x28x1 images")
        self.z_dim, self.noise_dim = z_dim, z0_dim
        self.z0_min_std = 1.0 if clipped else 0.0
        clip = None if clipped else "spm4"
        self.afun = get_nonlinear_func(nonlinearity)
        self.trunk = ResConvTrunk(c_dim, nonlinearity, do_center)
        self.aux_reparam = NormalHead(c_dim, z0_dim, clip=clip)
        self.enc_fc = Linear(c_dim + z0_dim, c_dim)
        self.enc_reparam = NormalHead(c_dim, z_dim, clip=clip)
        self.decode = ResConvDecoder(z_dim, c_dim, nonlinearity)

    def trunk_feats(self, x):
        return self.trunk(x)

    def aux_params(self, ctx):
        return (*self.aux_reparam(ctx), ctx)

    def main_params(self, ctx_rows, z0):
        h = self.afun(self.enc_fc(torch.cat([ctx_rows, z0], dim=1)))
        return (*self.enc_reparam(h), h)
