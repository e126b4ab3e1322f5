"""``mnist-concat`` (implicit MLP; lim0606/pytorch-ardae-vae
models/ivae/mnist.py:123-238): an MLP trunk of model_n_layers + 1 hidden
layers on the centred input, the first fc split into a per-item and a
per-draw part, and an MLP decoder of model_n_layers hidden layers."""

from portbench.reference import layers as L


def spec(cfg):
    out = {}
    h, nl, z = cfg["model_h_dim"], cfg["model_n_layers"], cfg["model_z_dim"]
    pixels = cfg["nchannels"] * cfg["nheight"] ** 2
    L.mlp_spec(out, "encode.inp_encode", pixels, h, h, nl + 1)
    L.lin_spec(out, "encode.fc_l0_inp", h, h)
    L.lin_spec(out, "encode.fc_l0_eps", h, cfg["model_n_dim"], bias=False)
    L.lin_spec(out, "encode.fc_out", z, h)
    L.mlp_spec(out, "decode.main", z, h, h, nl)
    L.lin_spec(out, "decode.reparam_logit", pixels, h)
    return out


def sample_z(cfg, P, x, eps):
    act, h, nl = L.ACTS[cfg["model_nonlin"]], cfg["model_h_dim"], cfg["model_n_layers"]
    bsz = x.shape[0]
    nz = eps.shape[0] // bsz
    code = L.mlp(P, "encode.inp_encode", 2.0 * x.reshape(bsz, -1) - 1.0, nl + 1, act, True)
    h_l0 = L.linear(P, "encode.fc_l0_inp", code)[:, None, :] \
        + L.linear(P, "encode.fc_l0_eps", eps).reshape(bsz, nz, h)
    z = L.linear(P, "encode.fc_out", act(h_l0.reshape(bsz * nz, h)))
    return z.reshape(bsz, nz, cfg["model_z_dim"])


def decode_logits(cfg, P, z):
    act = L.ACTS[cfg["model_nonlin"]]
    h = L.mlp(P, "decode.main", z, cfg["model_n_layers"], act, True)
    return L.linear(P, "decode.reparam_logit", h)
