"""Model factories keyed by the reference CLI names (JAX twin:
ardae_tpu/models/registry.py). The port has the flagship line's and the
implicit-conv line's entries; every other name raises NotImplementedError
naming the ROADMAP item that ports it. Both build functions put the module
on the card unless the caller asks for the CPU (``device="cpu"``); without
a card that default raises rather than falling back."""

import torch

from ardae_tpu_torch.models.cdae.cardae import MLPGradCARDAE, MLPResCARDAE
from ardae_tpu_torch.models.ivae.conv import ConvIPVAE
from ardae_tpu_torch.models.ivae.resconv import ResConvIPVAE
from ardae_tpu_torch.nn.initializers import init_module

_RESCONV = {"resconv-res": False, "resconvct-res": True}  # name -> do_center

_LATER = {
    "mlp-concat": "ROADMAP queue 1, slice 4 (item 12)",
    "mnist-concat": "ROADMAP queue 1, slice 4 (item 12)",
    "cdae mlp": "ROADMAP queue 1, slice 4 (item 12, models/cdae/legacy.py)",
}


def _later(name):
    if name in _LATER:
        return _LATER[name]
    if name.startswith("aux"):
        return "ROADMAP queue 1, slice 5 (item 13, hierarchical aux)"
    return "ROADMAP queue 1, slice 2 (item 10, the other resconv fc heads)"


def _init(module, seed, device):
    gen = torch.Generator().manual_seed(seed)
    return init_module(module, gen).to(device)


def build_ivae_model(name, *, nchannels=2, nheight=1, z_dim=2, h_dim=128,
                     n_dim=2, n_layers=2, nonlin="relu", seed=0, device="cuda"):
    """The implicit VAE ``name``, parameters drawn from ``seed``. mnist-conv
    has fixed widths: ``h_dim`` and ``n_layers`` are not read."""
    if name == "mnist-conv":
        model = ConvIPVAE(input_height=nheight, input_channels=nchannels,
                          z_dim=z_dim, noise_dim=n_dim, nonlinearity=nonlin)
        return _init(model, seed, device)
    if name not in _RESCONV:
        raise NotImplementedError(
            f"ivae model {name!r} is not ported yet: {_later(name)}")
    model = ResConvIPVAE(input_height=nheight, input_channels=nchannels,
                         z_dim=z_dim, h_dim=h_dim, num_hidden_layers=n_layers,
                         noise_dim=n_dim, nonlinearity=nonlin,
                         do_center=_RESCONV[name], enc_type="res-wn-mlp")
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
