"""Model factories keyed by the reference CLI names (JAX twin:
ardae_tpu/models/registry.py). The port builds every implicit VAE name
(``mlp-concat``, ``mnist-concat``, ``mnist-conv``, the ten resconv names
and the seven aux ones), both cdae styles, and every baseline VAE name
(``toy``, ``toy-maf``, ``mnist``, ``conv``, ``resconv(ct)`` and the aux
``auxtoy``, ``auxmnist``, ``auxconv``, ``auxresconv(ct)``); ``--cdae mlp``
raises NotImplementedError, as JAX's registry raises for it. Every build
function puts the module on the card unless the caller asks for the CPU
(``device="cpu"``); without a card that default raises rather than falling
back."""

import torch

from ardae_tpu_torch.models.cdae.cardae import MLPGradCARDAE, MLPResCARDAE
from ardae_tpu_torch.models.ivae.aux import (
    CONV_FC,
    MNISTAuxIPVAE,
    MNISTConvAuxIPVAE,
    MNISTResConvAuxIPVAE,
    ToyAuxIPVAE,
)
from ardae_tpu_torch.models.ivae.conv import ConvIPVAE
from ardae_tpu_torch.models.ivae.mnist import MNISTIPVAE
from ardae_tpu_torch.models.ivae.resconv import ResConvIPVAE
from ardae_tpu_torch.models.ivae.toy import ToyIPVAE
from ardae_tpu_torch.models.vae.aux import (
    MNISTAuxVAE,
    MNISTConvAuxVAE,
    MNISTResConvAuxVAE,
    ToyAuxVAE,
)
from ardae_tpu_torch.models.vae.conv import MNISTConvVAE
from ardae_tpu_torch.models.vae.maf import ToyMAFVAE
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

AUX_RESCONV_C = 450  # the aux resconv trunk's context width (JAX registry)

_LATER = {
    # models/cdae/legacy.py has the legacy DAEs, but no registry builds one:
    # the JAX registry raises "unknown cdae: mlp" (ardae_tpu/models/
    # registry.py:182), and both drivers refuse --cdae mlp
    "cdae mlp": ("the legacy reconstruction DAE: no driver builds it, nor "
                 "any registry (JAX's raises 'unknown cdae: mlp'); "
                 "models/cdae/legacy.py has it for direct use"),
}


# auxresconv(ct)(-clip): (do_center, clipped), as the JAX registry builds them
_AUX_RESCONV = {"auxresconv": (False, False), "auxresconvct": (True, False),
                "auxresconv-clip": (False, True), "auxresconvct-clip": (True, True)}


def _later(name):
    if name in _LATER:
        return _LATER[name]
    raise NotImplementedError(f"unknown model: {name!r}")


def _init(module, seed, device):
    gen = torch.Generator().manual_seed(seed)
    return init_module(module, gen).to(device)


def build_ivae_model(name, *, nchannels=2, nheight=1, z_dim=2, h_dim=128,
                     n_dim=2, n_layers=2, nonlin="relu", seed=0, device="cuda"):
    """The implicit VAE ``name``, parameters drawn from ``seed``. mnist-conv,
    auxconv and the aux resconv models have fixed widths: ``h_dim`` and
    ``n_layers`` are not read (an aux model's ``n_dim`` is its z0 width)."""
    mlp = {"mlp-concat": ToyIPVAE, "mnist-concat": MNISTIPVAE,
           "auxmlp": ToyAuxIPVAE, "auxmnist": MNISTAuxIPVAE}
    if name in mlp:
        model = mlp[name](input_dim=nchannels * nheight * nheight,
                          noise_dim=n_dim, h_dim=h_dim, z_dim=z_dim,
                          nonlinearity=nonlin, num_hidden_layers=n_layers)
        return _init(model, seed, device)
    if name == "mnist-conv":
        model = ConvIPVAE(input_height=nheight, input_channels=nchannels,
                          z_dim=z_dim, noise_dim=n_dim, nonlinearity=nonlin)
        return _init(model, seed, device)
    if name == "auxconv":
        model = MNISTConvAuxIPVAE(input_height=nheight, input_channels=nchannels,
                                  z0_dim=n_dim, z_dim=z_dim, nonlinearity=nonlin)
        return _init(model, seed, device)
    if name in _AUX_RESCONV:
        do_center, clipped = _AUX_RESCONV[name]
        model = MNISTResConvAuxIPVAE(
            input_height=nheight, input_channels=nchannels, z0_dim=n_dim,
            z_dim=z_dim, c_dim=AUX_RESCONV_C, nonlinearity=nonlin,
            do_center=do_center, clipped=clipped)
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
    """The baseline VAE ``name``, parameters drawn from ``seed``. The conv
    and resconv models (aux or not) have fixed widths: ``h_dim`` and
    ``n_layers`` are not read. ``n_dim`` is an aux model's z0 width;
    ``clip_logvar`` clips auxtoy's and auxmnist's z0 head (auxresconv's two
    heads always carry spm4). ``resconvct`` and ``auxresconvct`` centre
    their input and the others do not, as in the JAX registry (the
    reference driver centres neither, vae.py:233-249)."""
    if name in ("toy", "toy-maf"):
        # toy-maf: the JAX registry's conditional-MAF realization of a model
        # the reference selects but never shipped (JAX registry.py:112-119)
        make = ToyVAE if name == "toy" else ToyMAFVAE
        model = make(input_dim=nchannels * nheight * nheight, h_dim=h_dim,
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
    elif name in ("auxtoy", "auxmnist"):
        make = ToyAuxVAE if name == "auxtoy" else MNISTAuxVAE
        model = make(input_dim=nchannels * nheight * nheight, noise_dim=n_dim,
                     h_dim=h_dim, z_dim=z_dim, nonlinearity=nonlin,
                     num_hidden_layers=n_layers, clip_logvar=clip_logvar)
    elif name == "auxconv":
        model = MNISTConvAuxVAE(input_height=nheight, input_channels=nchannels,
                                z0_dim=n_dim, z_dim=z_dim, nonlinearity=nonlin,
                                do_xavier=False)
    elif name in ("auxresconv", "auxresconvct"):
        model = MNISTResConvAuxVAE(input_height=nheight, input_channels=nchannels,
                                   z0_dim=n_dim, z_dim=z_dim, c_dim=AUX_RESCONV_C,
                                   nonlinearity=nonlin,
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
        if model_name in ("auxmlp", "auxmnist"):
            return 2 * h_dim
        if model_name == "auxconv":
            return 2 * CONV_FC
        if model_name in _AUX_RESCONV:
            return AUX_RESCONV_C
        return h_dim
    raise NotImplementedError(ctx_type)


def build_cdae(name, *, input_dim, context_dim, h_dim=128, n_layers=2,
               nonlin="relu", seed=0, device="cuda"):
    if name == "mlp-res":
        make = MLPResCARDAE
    elif name == "mlp-grad":
        make = MLPGradCARDAE
    else:
        raise NotImplementedError(
            f"cdae {name!r}: {_later('cdae ' + name)}")
    cdae = make(input_dim=input_dim, context_dim=context_dim, h_dim=h_dim,
                num_hidden_layers=n_layers, nonlinearity=nonlin)
    return _init(cdae, seed, device)
