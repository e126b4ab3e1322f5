"""The yardstick: the card's peaks, the least time of the DSM loss (the
operations and bytes of ``chip_smoke.py``'s ``products`` / ``flops`` /
``io_bytes`` / ``bound_ms``, frozen here over shapes), and the FLOP of one
whole joint step, counted from the configuration's shapes.

Peaks (NVIDIA's data sheet, H100 SXM, dense, at 700 W): TF32 495 TFLOP/s,
HBM 3.35 TB/s. The DSM kernels multiply fp32 operands as 3xTF32, three
TF32 products for each, so an fp32 product's rate is 495 / 3 = 165 TFLOP/s;
the whole step's share (``train_mfu_pct``) is taken against that rate in
every cell, plain or kernel.
"""

import torch

TF32_FLOPS, HBM_BYTES = 495e12, 3.35e12
PASSES = 3                        # 3xTF32
FP32_PEAK = TF32_FLOPS / PASSES   # 165 TFLOP/s


def dsm_layers(config):
    """The DSM chain's weights as the kernels take them, [(out, in)] with
    sigma's column in layer l0's in, and l0: the input encoder's layers,
    l0, the trunk's layers (``ops/fused_dsm.py`` ``flat_weights``)."""
    from portbench import reference as R

    z, h, nl = config["model_z_dim"], config["cdae_h_dim"], config["cdae_n_layers"]
    enc = [(h, z)] + [(h, h)] * (nl - 1)
    out = R.cdae(config).out_width(config)
    trunk = [(h, h)] * (nl - 1) + [(out, h)]
    return enc + [(h, h + 1)] + trunk, len(enc)


def products(kind, ws, l0):
    """The matrix products of one kernel entry point, (op, layer), op one of
    forward (x . W^T), input_grad (dp . W), weight_grad (dp^T . h): the res
    kernel's layers all; the grad kernel's hidden layers (its h -> 1 head
    has no product). Returns ({"fwd": [...], "bwd": [...]}, [(out, in)])."""
    dims = [(w[0], w[1] - (i == l0)) for i, w in enumerate(ws)]
    layers = range(len(dims) if kind == "res" else len(dims) - 1)
    fwd = [("forward", i) for i in layers]
    dgrad = [("input_grad", i) for i in layers if i > 0]
    wgrad = [("weight_grad", i) for i in layers]
    if kind == "res":
        return {"fwd": fwd, "bwd": wgrad + dgrad}, dims
    # grad style: forward + input-gradient chain (down to d e / d xbar);
    # tangent chain + two weight-gradient products a layer + primal adjoint
    return {"fwd": fwd + dgrad + [("input_grad", 0)],
            "bwd": fwd + wgrad + wgrad + dgrad}, dims


def flops(kind, ws, l0, n):
    ops, dims = products(kind, ws, l0)
    return {w: sum(2.0 * n * dims[i][0] * dims[i][1] for _, i in ops[w]) for w in ops}


def io_bytes(ws, n, d, bsz, h):
    """Bytes the function must move: each input read once and each output
    written once (fwd: xbar, eps, sigma, ctx_l0 and the weights -> loss;
    bwd: those and the cotangent -> every gradient)."""
    leaves = bsz * h + sum(o * i + o for o, i in ws)
    inputs = (n * d * 2 + n + leaves) * 4
    return {"fwd": inputs + 4, "bwd": inputs + 4 + leaves * 4}


def bound_ms(flop, nbytes):
    """(the least time for this work in ms, what bounds it): the products
    at the tensor cores' TF32 peak, three passes each, against the bytes at
    HBM's rate."""
    ops_ms = PASSES * flop / TF32_FLOPS * 1e3
    bytes_ms = nbytes / HBM_BYTES * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def dsm_bound_ms(config):
    """{"fwd", "bwd"}: the least ms of one phase-A DSM loss, forward and
    backward, at the configuration's rows."""
    from portbench import reference as R

    kind = R.cdae(config).STYLE
    ws, l0 = dsm_layers(config)
    bs, h = config["train_batch_size"], config["cdae_h_dim"]
    n = bs * config["train_nz_cdae"] * config["train_nstd_cdae"]
    f = flops(kind, ws, l0, n)
    b = io_bytes(ws, n, config["model_z_dim"], bs, h)
    return {w: bound_ms(f[w], b[w])[0] for w in ("fwd", "bwd")}


def step_flop(config):
    """The FLOP of one joint step (matrix products and convolutions, forward
    and backward, as ``torch.utils.flop_counter`` counts them) of the plain
    reference at the configuration's shapes, on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    from portbench import reference as R
    from portbench.reference import step as S

    dev = torch.device("meta")
    bs, nz, nstd = config["train_batch_size"], config["train_nz_cdae"], config["train_nstd_cdae"]
    z, nzm = config["model_z_dim"], config["train_nz_model"]
    pix = config["nchannels"] * config["nheight"] ** 2
    specs = R.specs(config)
    P = {k: torch.empty(s, device=dev, requires_grad=True) for k, s in specs["model"].items()}
    Q = {k: torch.empty(s, device=dev, requires_grad=True) for k, s in specs["cdae"].items()}

    def noise(rows):
        t = tuple(torch.empty(rows, w, device=dev) for w in R.noise_widths(config))
        return t[0] if len(t) == 1 else t

    opt_m = S.Optimizer(config["m_optimizer"], P, 1e-3, config["m_beta1"], config["m_momentum"])
    opt_d = S.Optimizer(config["d_optimizer"], Q, 1e-3, config["d_beta1"], config["d_momentum"])
    x = torch.empty(bs, pix, device=dev)
    with FlopCounterMode(display=False) as counter:
        for _ in range(config["num_cdae_updates"]):
            S.cdae_update(config, P, Q, opt_d, x, {
                "latent_eps": noise(bs * nz),
                "std": torch.empty(bs, nz * nstd, 1, device=dev),
                "dsm_eps": torch.empty(bs * nz * nstd, z, device=dev)})
        S.model_update(config, P, Q, opt_m, x, {"eps": noise(bs * nzm)}, 1.0)
    return float(counter.get_total_flops())
