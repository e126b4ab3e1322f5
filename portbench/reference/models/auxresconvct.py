"""``auxresconvct`` (the paper's hierarchical implicit posterior;
lim0606/pytorch-ardae-vae models/ivae/auxresconv.py:48-411): one shared
residual-conv trunk on the centred input, C 450 wide, feeds a reparameterised
Gaussian z0 head (noise 100 wide) and, through ``enc_fc`` over cat(trunk, z0)
and the nonlinearity, the feature h of a second Gaussian head, z. Both heads
clamp their log-variance by spm4, softplus(l + 4) - 4 (reference :70-72).
The decoder is the flagship's residual-conv decoder at C 450. The hidden1a
context is h at std 0 (reference :126-132).

Departures from the reference, as the program runs the line:
  * the input is centred, 2x - 1 (the ``ct`` names; the reference trainer
    centres neither, vae.py:233-249), as the flagship's reference does;
  * the noise is a pair made outside, eps0 (rows, 100) then eps (rows, 32),
    unscaled: z0 = mu0 + exp(logvar0 / 2) eps0, z = mu + exp(logvar / 2) eps;
  * the std-0 passes take z0 = mu0 and z = mu, the reference's draws at
    std 0.

The trunk and the decoder are ``resconvct-res.py``'s, whose functions read
only the weights they are given and so take C 450 as they take C 512.
"""

import torch
import torch.nn.functional as F

from portbench import reference as R
from portbench.reference import layers as L

C = 450


def _flat():
    return R.part("models", "resconvct-res")


def spec(cfg):
    flat, out = _flat(), {}
    z, nd = cfg["model_z_dim"], cfg["model_n_dim"]
    for i, (cin, cout, _) in enumerate(flat.TRUNK):
        L.resconv_block_spec(out, f"trunk.block{i}", cin, cout)
    L.reslinear_spec(out, "trunk.fc", 32 * 4 * 4, C, True)
    L.lin_spec(out, "aux_reparam.mean_fn", nd, C)
    L.lin_spec(out, "aux_reparam.logvar_fn", nd, C)
    L.lin_spec(out, "enc_fc", C, C + nd)
    L.lin_spec(out, "enc_reparam.mean_fn", z, C)
    L.lin_spec(out, "enc_reparam.logvar_fn", z, C)
    L.reslinear_spec(out, "decode.fc0", z, C, True)
    L.reslinear_spec(out, "decode.fc1", C, 32 * 4 * 4, True)
    for i, (cin, cout) in enumerate(flat.DECODER):
        L.resconv_block_spec(out, f"decode.block{i}", cin, cout)
    return out


def noise_widths(cfg):
    return (cfg["model_n_dim"], cfg["model_z_dim"])


def _spm4(logvar):
    return F.softplus(logvar + 4.0) - 4.0


def _head(P, name, h):
    """(mean, spm4-clamped log-variance) of a Gaussian head."""
    return L.linear(P, f"{name}.mean_fn", h), _spm4(L.linear(P, f"{name}.logvar_fn", h))


def _feature(cfg, P, trunk_rows, z0):
    return L.ACTS[cfg["model_nonlin"]](L.linear(P, "enc_fc", torch.cat([trunk_rows, z0], -1)))


def sample_z(cfg, P, x, eps):
    """(bsz, nz, z) for the noise pair ``eps`` = (eps0, eps), each
    (bsz * nz, width), an item's rows together."""
    eps0, eps1 = eps
    bsz = x.shape[0]
    nz = eps0.shape[0] // bsz
    trunk = _flat()._trunk(P, x, L.ACTS[cfg["model_nonlin"]])
    mu0, lv0 = _head(P, "aux_reparam", trunk)
    rows = lambda t: t[:, None, :].expand(bsz, nz, t.shape[-1]).reshape(bsz * nz, -1)
    z0 = rows(mu0) + torch.exp(0.5 * rows(lv0)) * eps0
    mu, lv = _head(P, "enc_reparam", _feature(cfg, P, rows(trunk), z0))
    return (mu + torch.exp(0.5 * lv) * eps1).reshape(bsz, nz, cfg["model_z_dim"])


def decode_logits(cfg, P, z):
    return _flat().decode_logits(cfg, P, z)


def hidden1a_width(cfg):
    return C


def hidden1a(cfg, P, x):
    """The std-0 feature h (bsz, C): z0 at its mean."""
    trunk = _flat()._trunk(P, x, L.ACTS[cfg["model_nonlin"]])
    mu0, _ = _head(P, "aux_reparam", trunk)
    return _feature(cfg, P, trunk, mu0)
