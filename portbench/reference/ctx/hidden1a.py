"""``hidden1a``: the cdae's context is a hierarchical encoder's hidden
feature at std 0 (ivae_ardae.py:737-741, the encoder's ``forward_hidden``
with std 0; for auxresconvct the feature h over cat(trunk, z0 = mu0), 450
wide). The model's reference module computes it and gives its width."""


def width(cfg, model):
    return model.hidden1a_width(cfg)


def context(cfg, model, P, x, latent_mean):
    """(bsz, width) of the batch ``x``; ``latent_mean`` is not read."""
    return model.hidden1a(cfg, P, x)
