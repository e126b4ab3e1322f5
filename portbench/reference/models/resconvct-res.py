"""``resconvct-res`` (the flagship's model; lim0606/pytorch-ardae-vae
models/vae/resconv.py, models/ivae/resconv.py): a residual-conv trunk of
weight-normalised convs on the centred input, a c 512 code per item
concatenated with each noise draw, a residual weight-normalised MLP head,
and the residual-conv decoder with bilinear x2 upsampling (align_corners)."""

import torch

from portbench.reference import layers as L

C = 512
TRUNK = [(1, 16, 2), (16, 16, 1), (16, 32, 2), (32, 32, 1), (32, 32, 2)]
DECODER = [(32, 32), (32, 32), (32, 16), (16, 16), (16, 1)]


def spec(cfg):
    out = {}
    z, nd, h = cfg["model_z_dim"], cfg["model_n_dim"], cfg["model_h_dim"]
    for i, (cin, cout, _) in enumerate(TRUNK):
        L.resconv_block_spec(out, f"trunk.block{i}", cin, cout)
    L.reslinear_spec(out, "trunk.fc", 32 * 4 * 4, C, True)
    prev = C + nd
    for i in range(cfg["model_n_layers"]):
        L.reslinear_spec(out, f"fc.layers.{i}", prev, h)
        prev = h
    L.reslinear_spec(out, "fc.fc", prev, z)
    L.reslinear_spec(out, "decode.fc0", z, C, True)
    L.reslinear_spec(out, "decode.fc1", C, 32 * 4 * 4, True)
    for i, (cin, cout) in enumerate(DECODER):
        L.resconv_block_spec(out, f"decode.block{i}", cin, cout)
    return out


def _trunk(P, x, act):
    h = 2.0 * x.reshape(x.shape[0], 1, 28, 28) - 1.0   # resconvct centres
    for i, (_, _, stride) in enumerate(TRUNK):
        h = act(L.resconv_block(P, f"trunk.block{i}", h, stride))
    return act(L.reslinear(P, "trunk.fc", h.reshape(x.shape[0], -1), True))


def sample_z(cfg, P, x, eps):
    act = L.ACTS[cfg["model_nonlin"]]
    bsz = x.shape[0]
    nz = eps.shape[0] // bsz
    inp = _trunk(P, x, act)
    h = torch.cat([inp[:, None, :].expand(bsz, nz, inp.shape[-1]),
                   eps.reshape(bsz, nz, -1)], dim=-1).reshape(bsz * nz, -1)
    for i in range(cfg["model_n_layers"]):
        h = act(L.reslinear(P, f"fc.layers.{i}", h, False))
    return L.reslinear(P, "fc.fc", h, False).reshape(bsz, nz, cfg["model_z_dim"])


def decode_logits(cfg, P, z):
    act = L.ACTS[cfg["model_nonlin"]]
    bsz = z.shape[0]
    h = act(L.reslinear(P, "decode.fc0", z, True))
    h = act(L.reslinear(P, "decode.fc1", h, True)).reshape(bsz, 32, 4, 4)
    h = L.upsample2(h)                                      # 8 x 8
    h = act(L.resconv_block(P, "decode.block0", h, 1))
    h = act(L.resconv_block(P, "decode.block1", h, 1))
    h = L.upsample2(h[:, :, :-1, :-1])                      # 7 -> 14
    h = act(L.resconv_block(P, "decode.block2", h, 1))
    h = act(L.resconv_block(P, "decode.block3", h, 1))
    h = L.upsample2(h)                                      # 28 x 28
    return L.resconv_block(P, "decode.block4", h, 1).reshape(bsz, -1)
