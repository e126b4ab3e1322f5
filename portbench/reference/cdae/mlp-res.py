"""``mlp-res`` (resdae mlp.py): the res-style conditional AR-DAE, whose
score is the trunk's z-wide output."""

from portbench.reference import layers as L

STYLE = "res"     # the port's name of this score style
TRUNK = "dae"


def out_width(cfg):
    return cfg["model_z_dim"]


def spec(cfg, ctx_width):
    return L.cardae_spec(cfg, TRUNK, out_width(cfg), ctx_width)


def ctx_l0(cfg, Q, ctx):
    return L.cardae_ctx_l0(cfg, Q, TRUNK, ctx)


def score(cfg, Q, x, c0, std, create_graph):
    """(n, z) rows -> (n, z) scores."""
    return L.cardae_trunk(cfg, Q, TRUNK, x, c0, std)
