"""Hierarchical-aux baseline VAEs: a Gaussian q(z0|x), then q(z|x,z0), and
an auxiliary decoder r(z0|x,z) (JAX twin: ardae_tpu/models/vae/aux.py;
reference models/vae/aux*.py).

ELBO (reference models/vae/auxmnist.py:313-335):
    loss = recon + beta * KL(q(z) || N(0, I)) + beta * KL(q(z0|x) || r(z0|x,z))
and the hierarchical IWAE with exact densities (reference :381-451) in one
pass over bsz x ssz rows.

Aux baseline API (``family = "aux_gaussian_posterior"``):
  trunk_feats(x)               the carrier (2x - 1 or raw x, or the resconv
                               trunk's context)
  aux_params(feats)            -> (mu0, logvar0)
  main_params(feats, z0, nz)   -> (mu, logvar)
  auxdec_params(feats, z, nz)  -> (mu_r0, logvar_r0)
  decode_params(z_flat)
``main_params`` / ``auxdec_params`` take per-item ``feats`` and nz draws
per item. Every draw is injected (``eps=``, the pair (eps0, eps)) or comes
from an explicit ``torch.Generator``.

Variants: ``ToyAuxVAE`` (auxtoy), ``MNISTAuxVAE`` (auxmnist),
``MNISTConvAuxVAE`` (auxconv: three conv towers) and
``MNISTResConvAuxVAE`` (auxresconv(ct): one shared resconv trunk, spm4 on
the z0 and z heads). The registry builds them all without xavier (the JAX
registry's do_xavier=False; the reference driver passes it, vae.py:
263-275), so the JAX twins' ``do_xavier`` / ``do_m5bias`` are not ported;
only the decoders keep their own xavier law.
"""

import torch
import torch.nn as nn

from ardae_tpu_torch.core.losses import (
    iwae_bound,
    loss_kld_gaussian,
    loss_kld_gaussian_vs_gaussian,
    reduce_batch,
)
from ardae_tpu_torch.core.rng import sample_gaussian
from ardae_tpu_torch.core.stats import logprob_gaussian
from ardae_tpu_torch.models.ivae import api as ivae_api
from ardae_tpu_torch.models.ivae.aux import CONV_FC, bcast_rows
from ardae_tpu_torch.models.ivae.mnist import MNISTDecoder
from ardae_tpu_torch.models.ivae.toy import ToyDecoder
from ardae_tpu_torch.models.vae.conv import ConvDecoder, ConvEncoderTrunk
from ardae_tpu_torch.models.vae.resconv import ResConvDecoder, ResConvTrunk
from ardae_tpu_torch.nn.activations import get_nonlinear_func
from ardae_tpu_torch.nn.heads import NormalHead
from ardae_tpu_torch.nn.linear import Linear
from ardae_tpu_torch.nn.mlp import MLP


class _AuxVAE(nn.Module):
    family = "aux_gaussian_posterior"

    def decode_params(self, z_flat):
        return self.decode(z_flat)


class _MLPAuxVAE(_AuxVAE):
    """MLP towers ``aux_main`` / ``enc_fc`` / ``auxdec_fc`` (each
    num_hidden_layers - 1 hidden layers, nonlinear output) into Normal
    heads; ``clip_logvar`` clips the z0 head only, as in the JAX twin."""

    def __init__(self, input_dim, noise_dim, h_dim, z_dim, nonlinearity,
                 num_hidden_layers, clip_logvar):
        super().__init__()
        self.z_dim, self.noise_dim = z_dim, noise_dim
        mlp = dict(nonlinearity=nonlinearity,
                   num_hidden_layers=num_hidden_layers - 1,
                   use_nonlinearity_output=True)
        self.aux_main = MLP(input_dim, h_dim, h_dim, **mlp)
        self.aux_reparam = NormalHead(h_dim, noise_dim, clip=clip_logvar)
        self.enc_fc = MLP(input_dim + noise_dim, h_dim, h_dim, **mlp)
        self.enc_reparam = NormalHead(h_dim, z_dim)
        self.auxdec_fc = MLP(input_dim + z_dim, h_dim, h_dim, **mlp)
        self.auxdec_reparam = NormalHead(h_dim, noise_dim)

    def aux_params(self, feats):
        return self.aux_reparam(self.aux_main(feats))

    def main_params(self, feats, z0, nz=1):
        rows = bcast_rows(feats, feats.shape[0], nz)
        return self.enc_reparam(self.enc_fc(torch.cat([rows, z0], dim=1)))

    def auxdec_params(self, feats, z, nz=1):
        rows = bcast_rows(feats, feats.shape[0], nz)
        return self.auxdec_reparam(self.auxdec_fc(torch.cat([rows, z], dim=1)))


class MNISTAuxVAE(_MLPAuxVAE):
    """auxmnist baseline (reference models/vae/auxmnist.py:268-451): towers
    over 2x - 1, the MNIST decoder."""

    likelihood = "bernoulli"
    center_input = True

    def __init__(self, input_dim=784, noise_dim=100, h_dim=300, z_dim=32,
                 nonlinearity="softplus", num_hidden_layers=2, clip_logvar=None):
        super().__init__(input_dim, noise_dim, h_dim, z_dim, nonlinearity,
                         num_hidden_layers, clip_logvar)
        self.decode = MNISTDecoder(input_dim, z_dim, h_dim, nonlinearity,
                                   num_hidden_layers - 1)

    def trunk_feats(self, x):
        return 2.0 * x.reshape(x.shape[0], -1) - 1.0


class ToyAuxVAE(_MLPAuxVAE):
    """auxtoy baseline (reference models/vae/auxtoy.py): towers over the
    raw input, the toy Gaussian decoder."""

    likelihood = "gaussian"
    center_input = False

    def __init__(self, input_dim=2, noise_dim=2, h_dim=64, z_dim=2,
                 nonlinearity="softplus", num_hidden_layers=1, clip_logvar=None):
        super().__init__(input_dim, noise_dim, h_dim, z_dim, nonlinearity,
                         num_hidden_layers, clip_logvar)
        self.decode = ToyDecoder(input_dim, z_dim, h_dim, nonlinearity,
                                 num_hidden_layers)

    def trunk_feats(self, x):
        return x.reshape(x.shape[0], -1)


class MNISTConvAuxVAE(_AuxVAE):
    """auxconv baseline (reference models/vae/auxconv.py:33-369): three
    conv towers (aux encoder, main encoder, aux decoder), each its own trunk
    on the image and an 800-wide fc."""

    likelihood = "bernoulli"
    center_input = True

    def __init__(self, input_height=28, input_channels=1, z0_dim=100, z_dim=32,
                 nonlinearity="softplus"):
        super().__init__()
        self.z_dim, self.noise_dim = z_dim, z0_dim
        self.afun = get_nonlinear_func(nonlinearity)
        trunk = dict(input_height=input_height, input_channels=input_channels,
                     nonlinearity=nonlinearity)
        self.aux_trunk = ConvEncoderTrunk(**trunk)
        feat = 32 * self.aux_trunk.s ** 2
        self.aux_fc = Linear(feat, CONV_FC)
        self.aux_reparam = NormalHead(CONV_FC, z0_dim)
        self.enc_trunk = ConvEncoderTrunk(**trunk)
        self.enc_fc = Linear(feat + z0_dim, CONV_FC)
        self.enc_reparam = NormalHead(CONV_FC, z_dim)
        self.auxdec_trunk = ConvEncoderTrunk(**trunk)
        self.auxdec_fc = Linear(feat + z_dim, CONV_FC)
        self.auxdec_reparam = NormalHead(CONV_FC, z0_dim)
        self.decode = ConvDecoder(z_dim, input_height, input_channels,
                                  nonlinearity)

    def trunk_feats(self, x):
        return x.reshape(x.shape[0], -1)

    def aux_params(self, feats):
        return self.aux_reparam(self.afun(self.aux_fc(self.aux_trunk(feats))))

    def main_params(self, feats, z0, nz=1):
        trunk = bcast_rows(self.enc_trunk(feats), feats.shape[0], nz)
        return self.enc_reparam(self.afun(self.enc_fc(torch.cat([trunk, z0], 1))))

    def auxdec_params(self, feats, z, nz=1):
        trunk = bcast_rows(self.auxdec_trunk(feats), feats.shape[0], nz)
        return self.auxdec_reparam(self.afun(self.auxdec_fc(torch.cat([trunk, z], 1))))


class MNISTResConvAuxVAE(_AuxVAE):
    """auxresconv(ct) baseline (reference models/vae/auxresconv.py:26-461):
    one shared resconv trunk; the z0 head reads its context, the z and r
    heads read act(Linear(cat(context, z0 or z))). The z0 and z heads carry
    the spm4 clamp (the JAX twin's default, which its registry keeps)."""

    likelihood = "bernoulli"
    center_input = True

    def __init__(self, input_height=28, input_channels=1, z0_dim=100, z_dim=32,
                 c_dim=450, nonlinearity="elu", do_center=False):
        super().__init__()
        if input_height != 28 or input_channels != 1:
            raise ValueError("MNISTResConvAuxVAE takes 28x28x1 images")
        self.z_dim, self.noise_dim = z_dim, z0_dim
        self.afun = get_nonlinear_func(nonlinearity)
        self.trunk = ResConvTrunk(c_dim, nonlinearity, do_center)
        self.aux_reparam = NormalHead(c_dim, z0_dim, clip="spm4")
        self.enc_fc = Linear(c_dim + z0_dim, c_dim)
        self.enc_reparam = NormalHead(c_dim, z_dim, clip="spm4")
        self.auxdec_fc = Linear(c_dim + z_dim, c_dim)
        self.auxdec_reparam = NormalHead(c_dim, z0_dim)
        self.decode = ResConvDecoder(z_dim, c_dim, nonlinearity)

    def trunk_feats(self, x):
        return self.trunk(x)

    def aux_params(self, ctx):
        return self.aux_reparam(ctx)

    def main_params(self, ctx, z0, nz=1):
        rows = bcast_rows(ctx, ctx.shape[0], nz)
        return self.enc_reparam(self.afun(self.enc_fc(torch.cat([rows, z0], 1))))

    def auxdec_params(self, ctx, z, nz=1):
        rows = bcast_rows(ctx, ctx.shape[0], nz)
        return self.auxdec_reparam(self.afun(self.auxdec_fc(torch.cat([rows, z], 1))))


def _pair(eps):
    return (None, None) if eps is None else eps


def encode_sample(module, feats, generator=None, eps=None):
    """z0 ~ q(z0|x), then z ~ q(z|x,z0), one draw an item: (mu0, lv0, z0,
    mu, lv, z). ``eps``: the pair (eps0 (bsz, noise_dim), eps (bsz,
    z_dim)), else drawn from ``generator``, z0's first."""
    eps0, eps1 = _pair(eps)
    mu0, lv0 = module.aux_params(feats)
    z0 = sample_gaussian(mu0, lv0, generator, eps0)
    mu, lv = module.main_params(feats, z0)
    z = sample_gaussian(mu, lv, generator, eps1)
    return mu0, lv0, z0, mu, lv, z


def aux_vae_loss(module, x, beta=1.0, reduce="mean", generator=None, eps=None):
    """recon + beta * KL(q(z)) + beta * KL(q(z0) || r(z0|x,z)) (reference
    models/vae/auxmnist.py:313-361), its batch mean or with
    ``reduce='per_item'`` the (bsz,) vector. Returns (loss, {"recon", "kld":
    the two KLDs' batch means summed, logged as one (reference :361),
    "z"})."""
    feats = module.trunk_feats(x)
    mu0, lv0, _, mu, lv, z = encode_sample(module, feats, generator, eps)
    mup0, lvp0 = module.auxdec_params(feats, z)
    recon = ivae_api.recon_loss_fn(module, module.decode_params(z), x)
    kld = loss_kld_gaussian(mu, lv, reduce="per_item")
    aux_kld = loss_kld_gaussian_vs_gaussian(mu0, lv0, mup0, lvp0,
                                            reduce="per_item")
    loss = reduce_batch(recon + beta * kld + beta * aux_kld, reduce)
    return loss, {"recon": torch.mean(recon),
                  "kld": torch.mean(kld) + torch.mean(aux_kld), "z": z}


def aux_logprob_iwae(module, x, sample_size, reduce="mean", generator=None,
                     eps=None):
    """Hierarchical IWAE, logw = log p(x|z) + log p(z) + log r(z0|x,z) -
    log q(z|x,z0) - log q(z0|x) (reference models/vae/auxmnist.py:381-451),
    over bsz x ssz rows at once. ``eps``: the pair (eps0 (bsz*ssz,
    noise_dim), eps (bsz*ssz, z_dim)), else drawn from ``generator``."""
    bsz, ssz = x.shape[0], sample_size
    eps0, eps1 = _pair(eps)
    feats = module.trunk_feats(x)
    mu0, lv0 = module.aux_params(feats)
    mu0r, lv0r = bcast_rows(mu0, bsz, ssz), bcast_rows(lv0, bsz, ssz)
    z0 = sample_gaussian(mu0r, lv0r, generator, eps0)
    log_qz0 = torch.sum(logprob_gaussian(mu0r, lv0r, z0), dim=-1)
    mu, lv = module.main_params(feats, z0, ssz)
    z = sample_gaussian(mu, lv, generator, eps1)
    log_qz = torch.sum(logprob_gaussian(mu, lv, z), dim=-1)
    mup0, lvp0 = module.auxdec_params(feats, z, ssz)
    log_pz0 = torch.sum(logprob_gaussian(mup0, lvp0, z0), dim=-1)
    log_pz = torch.sum(logprob_gaussian(0.0, 0.0, z), dim=-1)
    ll = ivae_api.loglik(module, module.decode_params(z), x.reshape(bsz, 1, -1),
                         (bsz, ssz)).reshape(-1)
    logw = (ll + log_pz + log_pz0 - log_qz - log_qz0).reshape(bsz, ssz)
    return reduce_batch(iwae_bound(logw, dim=1), reduce)
