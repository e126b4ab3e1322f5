"""The layers the reference's models are built from, written from the
published layer equations (lim0606/pytorch-ardae-vae: models/layers.py,
models/vae/resconv.py, resdae/graddae mlp.py), frozen here.

Every net is a set of functions over a flat dict of named fp32 tensors.
The names are the ones the port's ``state_dict`` uses, so the benchmark can
load one set of weights into both sides; nothing here imports the port.
A spec is an OrderedDict name -> shape; the ``*_spec`` helpers add a
layer's leaves to one.
"""

import math

import torch
import torch.nn.functional as F

ACTS = {"elu": F.elu, "softplus": F.softplus, "relu": F.relu, "tanh": torch.tanh}


# ---- parameter layouts ------------------------------------------------------

def wn_spec(spec, name, out, inp, k=None):
    """A weight-normalised layer: direction, scale, bias."""
    spec[f"{name}.direction"] = (out, inp) if k is None else (out, inp, k, k)
    spec[f"{name}.scale"] = (out,)
    spec[f"{name}.bias"] = (out,)


def lin_spec(spec, name, out, inp, bias=True, k=None, transpose=False):
    if k is None:
        spec[f"{name}.weight"] = (out, inp)
    else:
        spec[f"{name}.weight"] = (inp, out, k, k) if transpose else (out, inp, k, k)
    if bias:
        spec[f"{name}.bias"] = (out,)


def mlp_spec(spec, name, inp, h, out, n_hidden):
    """``n_hidden`` hidden layers of width h, then ``fc``."""
    for i in range(n_hidden):
        lin_spec(spec, f"{name}.layers.{i}", h, inp if i == 0 else h)
    lin_spec(spec, f"{name}.fc", out, h if n_hidden else inp)


def resconv_block_spec(spec, name, cin, cout):
    wn_spec(spec, f"{name}.conv_0h", cout, cin, 3)
    wn_spec(spec, f"{name}.conv_h1", cout, cout, 3)
    wn_spec(spec, f"{name}.conv_01", cout, cin, 3)


def reslinear_spec(spec, name, inp, out, skip_layer=False):
    """A residual block; its skip is a layer where the widths differ, or
    always (``skip_layer``, torchkit's ResLinear)."""
    wn_spec(spec, f"{name}.dot_0h", out, inp)
    wn_spec(spec, f"{name}.dot_h1", out, out)
    if skip_layer or inp != out:
        wn_spec(spec, f"{name}.dot_01", out, inp)


def init_bounds(spec):
    """(bound, offset) of each leaf's law U(offset - bound, offset + bound):
    a weight or direction U(+-1/sqrt(fan_in)), its bias the same bound, a
    weight-norm scale 1."""
    out = {}
    for name, shape in spec.items():
        base, leaf = name.rsplit(".", 1)
        if leaf == "scale":
            out[name] = (0.0, 1.0)
            continue
        wshape = shape if leaf != "bias" else spec.get(
            f"{base}.weight", spec.get(f"{base}.direction"))
        fan_in = math.prod(wshape) // wshape[0]
        out[name] = (1.0 / math.sqrt(fan_in), 0.0)
    return out


# ---- layers -----------------------------------------------------------------

def wn_linear(P, name, x, norm):
    d = P[f"{name}.direction"]
    if norm:
        d = d / torch.sqrt(torch.sum(d * d, dim=1, keepdim=True))
    return F.linear(x, d) * P[f"{name}.scale"] + P[f"{name}.bias"]


def wn_conv(P, name, x, stride, padding):
    d = P[f"{name}.direction"]
    d = d / torch.sqrt(torch.sum(d * d, dim=(1, 2, 3), keepdim=True))
    w = d * P[f"{name}.scale"][:, None, None, None]
    return F.conv2d(x, w, P[f"{name}.bias"], stride=stride, padding=padding)


def resconv_block(P, name, x, stride):
    h = F.relu(wn_conv(P, f"{name}.conv_0h", x, stride, 1))
    return wn_conv(P, f"{name}.conv_h1", h, 1, 1) + wn_conv(P, f"{name}.conv_01", x, stride, 1)


def reslinear(P, name, x, norm):
    out = wn_linear(P, f"{name}.dot_h1", F.relu(wn_linear(P, f"{name}.dot_0h", x, norm)), norm)
    skip = wn_linear(P, f"{name}.dot_01", x, norm) if f"{name}.dot_01.direction" in P else x
    return out + skip


def linear(P, name, x):
    return F.linear(x, P[f"{name}.weight"], P.get(f"{name}.bias"))


def mlp(P, name, x, n_hidden, act, out_act):
    for i in range(n_hidden):
        x = act(linear(P, f"{name}.layers.{i}", x))
    x = linear(P, f"{name}.fc", x)
    return act(x) if out_act else x


def upsample2(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


# ---- the conditional AR-DAE's trunk, shared by both score styles --------------

def cardae_spec(cfg, trunk, out, ctx_width):
    """The conditional AR-DAE: the context and the input each through an
    MLP encoder, the first trunk layer split into a per-row part (the
    input's code and the noise level) and a per-item part (the context's
    code), then the trunk to ``out``."""
    spec = {}
    z, h, nl = cfg["model_z_dim"], cfg["cdae_h_dim"], cfg["cdae_n_layers"]
    mlp_spec(spec, "ctx_encode", ctx_width, h, h, nl - 1)
    mlp_spec(spec, "inp_encode", z, h, h, nl - 1)
    lin_spec(spec, f"{trunk}_l0_row", h, h + 1)
    lin_spec(spec, f"{trunk}_l0_ctx", h, h, bias=False)
    for i in range(nl - 1):
        lin_spec(spec, f"{trunk}.layers.{i}", h, h)
    lin_spec(spec, f"{trunk}.fc", out, h)
    return spec


def cardae_ctx_l0(cfg, Q, trunk, ctx):
    """The per-item part of the trunk's first layer."""
    act, nl = ACTS[cfg["cdae_nonlin"]], cfg["cdae_n_layers"]
    return linear(Q, f"{trunk}_l0_ctx", mlp(Q, "ctx_encode", ctx, nl - 1, act, True))


def cardae_trunk(cfg, Q, trunk, x, c0, std):
    """(n, z) rows, (bsz, h) per-item codes, (n, 1) noise levels -> the
    trunk's (n, out)."""
    act, nl = ACTS[cfg["cdae_nonlin"]], cfg["cdae_n_layers"]
    h = linear(Q, f"{trunk}_l0_row", torch.cat([mlp(Q, "inp_encode", x, nl - 1, act, True), std], -1))
    n, bsz = x.shape[0], c0.shape[0]
    h = (h.reshape(bsz, n // bsz, -1) + c0[:, None, :]).reshape(n, -1)
    return mlp(Q, trunk, act(h), nl - 1, act, False)
