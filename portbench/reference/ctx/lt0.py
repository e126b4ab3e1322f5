"""``lt0``: the cdae's context is the std-0 encoding, z wide
(ivae_ardae.py:735+748)."""


def width(cfg, model):
    return cfg["model_z_dim"]


def context(cfg, model, P, x, latent_mean):
    """(bsz, width) of the batch ``x``; ``latent_mean`` (bsz, 1, z) is its
    std-0 encoding, ``model`` the model's reference module."""
    return latent_mean.reshape(x.shape[0], -1)
