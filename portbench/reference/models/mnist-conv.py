"""``mnist-conv`` (implicit conv; lim0606/pytorch-ardae-vae
models/ivae/conv.py): three 5x5 stride-2 convs on the centred input, the
first fc split into a per-item and a per-draw part, the deconv decoder."""

import torch.nn.functional as F

from portbench.reference import layers as L

TRUNK = [(1, 16), (16, 32), (32, 32)]
DECONV = [("deconv1", 32, 32), ("deconv2", 32, 16), ("reparam_logit", 16, 1)]
FC4 = 800


def spec(cfg):
    out = {}
    for i, (cin, cout) in enumerate(TRUNK):
        L.lin_spec(out, f"trunk.conv{i + 1}", cout, cin, k=5)
    L.lin_spec(out, "fc4_inp", FC4, 32 * 4 * 4)
    L.lin_spec(out, "fc4_eps", FC4, cfg["model_n_dim"], bias=False)
    L.lin_spec(out, "fc5", cfg["model_z_dim"], FC4)
    L.lin_spec(out, "decode.fc.layers.0", 300, cfg["model_z_dim"])
    L.lin_spec(out, "decode.fc.fc", 32 * 4 * 4, 300)
    for name, cin, cout in DECONV:
        L.lin_spec(out, f"decode.{name}", cout, cin, k=5, transpose=True)
    return out


def sample_z(cfg, P, x, eps):
    act = L.ACTS[cfg["model_nonlin"]]
    bsz = x.shape[0]
    nz = eps.shape[0] // bsz
    h = 2.0 * x.reshape(bsz, 1, 28, 28) - 1.0
    for i in range(len(TRUNK)):
        h = act(F.conv2d(h, P[f"trunk.conv{i + 1}.weight"], P[f"trunk.conv{i + 1}.bias"],
                         stride=2, padding=2))
    h_inp = L.linear(P, "fc4_inp", h.reshape(bsz, -1))
    h4 = h_inp[:, None, :] + L.linear(P, "fc4_eps", eps).reshape(bsz, nz, FC4)
    return L.linear(P, "fc5", act(h4.reshape(bsz * nz, FC4))).reshape(bsz, nz, cfg["model_z_dim"])


def decode_logits(cfg, P, z):
    act = L.ACTS[cfg["model_nonlin"]]
    h = act(L.linear(P, "decode.fc.layers.0", z))
    h = act(L.linear(P, "decode.fc.fc", h)).reshape(z.shape[0], 32, 4, 4)
    h = act(F.conv_transpose2d(h, P["decode.deconv1.weight"], P["decode.deconv1.bias"],
                               stride=2, padding=2))        # 7 x 7
    h = F.pad(h, (0, 1, 0, 1))                              # 8 x 8
    h = act(F.conv_transpose2d(h, P["decode.deconv2.weight"], P["decode.deconv2.bias"],
                               stride=2, padding=2))        # 15 x 15
    logit = F.conv_transpose2d(h, P["decode.reparam_logit.weight"],
                               P["decode.reparam_logit.bias"], stride=2, padding=2)
    return logit[..., :-1, :-1].reshape(z.shape[0], -1)     # 29 -> 28
