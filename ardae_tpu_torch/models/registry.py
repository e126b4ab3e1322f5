"""Model factories keyed by the reference CLI names (JAX twin:
ardae_tpu/models/registry.py). The port builds the implicit VAEs
``mlp-concat``, ``mnist-concat``, ``mnist-conv`` and all ten resconv names,
both cdae styles, and the baseline VAEs ``toy``, ``mnist``, ``conv``,
``resconv`` and ``resconvct``; every other name raises NotImplementedError
naming the ROADMAP item that ports it. Every build function puts the module
on the card unless the caller asks for the CPU (``device="cpu"``); without
a card that default raises rather than falling back."""

import torch

from ardae_tpu_torch.models.cdae.cardae import MLPGradCARDAE, MLPResCARDAE
from ardae_tpu_torch.models.ivae.conv import ConvIPVAE
from ardae_tpu_torch.models.ivae.mnist import MNISTIPVAE
from ardae_tpu_torch.models.ivae.resconv import ResConvIPVAE
from ardae_tpu_torch.models.ivae.toy import ToyIPVAE
from ardae_tpu_torch.models.vae.conv import MNISTConvVAE
from ardae_tpu_torch.models.vae.mnist import MNISTVAE
from ardae_tpu_torch.models.vae.resconv import MNISTResConvVAE
from ardae_tpu_torch.models.vae.toy import ToyVAE
from ardae_tpu_torch.nn.initializers import init_module

_RESCONV_ENC = {  # name -> (fc head, do_center)
    "resconv": ("mlp", False), "resconvct": ("mlp", True),
    "resconv-res": ("res-wn-mlp", False), "resconvct-res": ("res-wn-mlp", True),
    "resconv-res2": ("res-mlp", False), "resconvct-res2": ("res-mlp", True),
    "resconv-res3": ("res-wn-mlp-lin", False),
    "resconvct-res3": ("res-wn-mlp-lin", True),
    "resconv-res4": ("res-mlp-lin", False), "resconvct-res4": ("res-mlp-lin", True),
}

_Q = "ROADMAP queue 1, "
_LATER = {
    "toy-maf": _Q + "slice 6 (item 14, nn/made.py + models/vae/maf.py)",
    # porting models/cdae/legacy.py (queue 1) will not make it build: both
    # drivers refuse --cdae mlp, as the JAX ones do
    "cdae mlp": ("the legacy reconstruction DAE, which no driver builds "
                 "(ROADMAP queue 1, models/cdae/legacy.py)"),
}


def _later(name):
    if name in _LATER:
        return _LATER[name]
    if name.startswith("aux"):
        return _Q + "slice 5 (item 13, hierarchical aux)"
    raise NotImplementedError(f"unknown model: {name!r}")


def _init(module, seed, device):
    gen = torch.Generator().manual_seed(seed)
    return init_module(module, gen).to(device)


def build_ivae_model(name, *, nchannels=2, nheight=1, z_dim=2, h_dim=128,
                     n_dim=2, n_layers=2, nonlin="relu", seed=0, device="cuda"):
    """The implicit VAE ``name``, parameters drawn from ``seed``. mnist-conv
    has fixed widths: ``h_dim`` and ``n_layers`` are not read."""
    concat = {"mlp-concat": ToyIPVAE, "mnist-concat": MNISTIPVAE}
    if name in concat:
        model = concat[name](input_dim=nchannels * nheight * nheight,
                             noise_dim=n_dim, h_dim=h_dim, z_dim=z_dim,
                             nonlinearity=nonlin, num_hidden_layers=n_layers)
        return _init(model, seed, device)
    if name == "mnist-conv":
        model = ConvIPVAE(input_height=nheight, input_channels=nchannels,
                          z_dim=z_dim, noise_dim=n_dim, nonlinearity=nonlin)
        return _init(model, seed, device)
    if name not in _RESCONV_ENC:
        raise NotImplementedError(
            f"ivae model {name!r} is not ported yet: {_later(name)}")
    enc_type, do_center = _RESCONV_ENC[name]
    model = ResConvIPVAE(input_height=nheight, input_channels=nchannels,
                         z_dim=z_dim, h_dim=h_dim, num_hidden_layers=n_layers,
                         noise_dim=n_dim, nonlinearity=nonlin,
                         do_center=do_center, enc_type=enc_type)
    return _init(model, seed, device)


def build_vae_model(name, *, nchannels=1, nheight=28, z_dim=8, h_dim=300,
                    n_dim=0, n_layers=1, nonlin="softplus", clip_logvar="none",
                    seed=0, device="cuda"):
    """The baseline VAE ``name``, parameters drawn from ``seed``. conv and
    resconv have fixed widths: ``h_dim`` and ``n_layers`` are not read, nor
    are ``n_dim`` and ``clip_logvar`` by any ported model. ``resconvct``
    centres its input and ``resconv`` does not, as in the JAX registry (the
    reference driver centres neither, vae.py:233-249)."""
    if name == "toy":
        model = ToyVAE(input_dim=nchannels * nheight * nheight, h_dim=h_dim,
                       z_dim=z_dim, nonlinearity=nonlin, num_hidden_layers=n_layers)
    elif name == "mnist":
        model = MNISTVAE(input_dim=nchannels * nheight * nheight, h_dim=h_dim,
                         z_dim=z_dim, nonlinearity=nonlin,
                         num_hidden_layers=n_layers)
    elif name == "conv":
        model = MNISTConvVAE(input_height=nheight, input_channels=nchannels,
                             z_dim=z_dim, nonlinearity=nonlin)
    elif name in ("resconv", "resconvct"):
        model = MNISTResConvVAE(input_height=nheight, input_channels=nchannels,
                                z_dim=z_dim, nonlinearity=nonlin,
                                do_center=name.endswith("ct"))
    else:
        raise NotImplementedError(
            f"vae model {name!r} is not ported yet: {_later(name)}")
    return _init(model, seed, device)


def context_dim_for(ctx_type, *, model_name, nchannels, nheight, z_dim, h_dim):
    """--cdae-ctx-type dimension (reference ivae_ardae.py:568-582)."""
    if ctx_type == "data":
        return nchannels * nheight * nheight
    if ctx_type == "lt0":
        return z_dim
    if ctx_type == "hidden1a":
        raise NotImplementedError(
            "hidden1a context is not ported yet: ROADMAP queue 1, slice 5 "
            "(item 13, hierarchical aux)")
    raise NotImplementedError(ctx_type)


def build_cdae(name, *, input_dim, context_dim, h_dim=128, n_layers=2,
               nonlin="relu", seed=0, device="cuda"):
    if name == "mlp-res":
        make = MLPResCARDAE
    elif name == "mlp-grad":
        make = MLPGradCARDAE
    else:
        raise NotImplementedError(
            f"cdae {name!r} is not ported yet: {_later('cdae ' + name)}")
    cdae = make(input_dim=input_dim, context_dim=context_dim, h_dim=h_dim,
                num_hidden_layers=n_layers, nonlinearity=nonlin)
    return _init(cdae, seed, device)
