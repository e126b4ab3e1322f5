"""``mlp-grad`` (graddae mlp.py): the grad-style conditional AR-DAE, whose
score is minus the gradient of its trunk's scalar energy (a double
backward under the DSM loss)."""

import torch

from portbench.reference import layers as L

STYLE = "grad"    # the port's name of this score style
TRUNK = "neglogprob"


def out_width(cfg):
    return 1


def spec(cfg, ctx_width):
    return L.cardae_spec(cfg, TRUNK, out_width(cfg), ctx_width)


def ctx_l0(cfg, Q, ctx):
    return L.cardae_ctx_l0(cfg, Q, TRUNK, ctx)


def score(cfg, Q, x, c0, std, create_graph):
    """(n, z) rows -> (n, z) scores."""
    with torch.enable_grad():
        xx = x.detach().requires_grad_(True)
        neg_energy = -torch.sum(L.cardae_trunk(cfg, Q, TRUNK, xx, c0, std)[:, 0])
        (g,) = torch.autograd.grad(neg_energy, xx, create_graph=create_graph)
    return g
