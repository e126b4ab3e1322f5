"""Baseline (Gaussian-posterior) VAE trainer CLI (JAX twin:
ardae_tpu/cli/vae.py; reference vae.py).

The whole flag surface parses (reference vae.py:28-127) and experiment
names match the JAX driver's. The port trains the MNIST-family baselines
``mnist``, ``conv``, ``resconv`` and ``resconvct`` and their hierarchical
twins ``auxmnist``, ``auxconv``, ``auxresconv`` and ``auxresconvct`` (the
aux ELBO and IWAE, models/vae/aux.py) on the MNIST family and sbMNIST, and
``toy`` and ``auxtoy`` on the toy datasets (swissroll, 25gaussians; a
Gaussian likelihood): one optimizer, the loss scaled by 1/(C*H*W) before
the backward, beta annealing, and the whole pipeline: train, the val IWAE
eval (exact q) every ``--eval-iws-interval`` steps with ``best-checkpoint``
on improvement, ``checkpoint`` every ``--ckpt-interval`` steps, resume from
it, ``--train-mode final`` (train+val up to the best checkpoint's
iteration, ``final-checkpoint``), and the test eval from the best (or
final) checkpoint; a toy run ends in the toy final dump instead
(``cli/common.py`` ``toy_final_dump``). The eval draws come from a
generator of their own seeded from (``--seed``, iteration), never from the
training generator. Flags and cadences the port does not cover raise
NotImplementedError naming their ROADMAP item whenever the run would use
them; none is ignored in silence.

Device: ``--no-cuda`` selects the CPU, as in the reference; otherwise the
run needs a CUDA device and raises without one.
"""

import argparse
import sys

import torch


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="swissroll",
                   choices=["swissroll", "25gaussians", "sbmnist", "dbmnist",
                            "dbmnist-val5k"])
    p.add_argument("--model", default="mnist",
                   choices=["toy", "toy-maf", "mnist", "conv", "resconv",
                            "resconvct", "auxtoy", "auxmnist", "auxconv",
                            "auxresconv", "auxresconvct"])
    p.add_argument("--model-z-dim", type=int, default=8)
    p.add_argument("--model-h-dim", type=int, default=300)
    p.add_argument("--model-n-dim", type=int, default=0)
    p.add_argument("--model-n-layers", type=int, default=1)
    p.add_argument("--model-nonlin", default="softplus")
    p.add_argument("--model-clip-logvar", default="none")
    p.add_argument("--nheight", type=int, default=28)
    p.add_argument("--nchannels", type=int, default=1)
    p.add_argument("--lr", type=float, default=0.0001)
    p.add_argument("--epochs", type=int, default=32000)
    p.add_argument("--train-batch-size", type=int, default=64)
    p.add_argument("--eval-batch-size", type=int, default=None,
                   help="eval grouping batch (per-item bound, the same math "
                        "for any value); default: at most 128 items and 2**25 "
                        "decoder pixels (reference default 32)")
    p.add_argument("--optimizer", default="adam",
                   choices=["sgd", "adam", "amsgrad", "rmsprop"])
    p.add_argument("--start-epoch", type=int, default=1)
    p.add_argument("--start-batch-idx", type=int, default=0)
    p.add_argument("--beta1", type=float, default=0.5)
    p.add_argument("--momentum", type=float, default=0.5)
    p.add_argument("--beta-init", type=float, default=1.0)
    p.add_argument("--beta-fin", type=float, default=1.0)
    p.add_argument("--beta-annealing", type=float, default=None)
    p.add_argument("--iws-samples", type=int, default=512)
    p.add_argument("--weight-avg", default="none",
                   choices=["none", "swa", "polyak"])
    p.add_argument("--weight-avg-start", type=int, default=1000)
    p.add_argument("--weight-avg-decay", type=float, default=0.998)
    p.add_argument("--train-mode", default="train", choices=["train", "final"])
    p.add_argument("--no-cuda", action="store_true", default=False)
    p.add_argument("--log-interval", type=int, default=500)
    p.add_argument("--vis-interval", type=int, default=5000)
    p.add_argument("--eval-iws-interval", type=int, default=1000)
    p.add_argument("--ckpt-interval", type=int, default=10000)
    p.add_argument("--sav-interval", type=int, default=0)
    p.add_argument("--resume", dest="resume", action="store_true", default=True)
    p.add_argument("--no-resume", dest="resume", action="store_false")
    p.add_argument("--cache", default=None)
    p.add_argument("--experiment", default=None)
    p.add_argument("--exp-num", type=int, default=None)
    # extensions of the JAX package (not in the reference surface)
    p.add_argument("--data-root", default="data")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--toy-train-size", type=int, default=2_000_000)
    p.add_argument("--max-iters", type=int, default=None,
                   help="hard iteration cap (smoke tests)")
    p.add_argument("--skip-final-test-eval", action="store_true", default=False,
                   help="skip the post-training test-set IWAE eval")
    p.add_argument("--dp-devices", type=int, default=0,
                   help="data-parallel device count (0 = off)")
    p.add_argument("--model-compute-dtype", default="float32",
                   choices=["float32", "bfloat16"])
    return p


def derive_experiment(opt):
    """Config-as-string experiment identity (reference vae.py:140-163)."""
    parts = [
        "vae",
        opt.dataset,
        "m{}-mz{}-mh{}-mn{}-mnh{}-ma{}-mcl{}".format(
            opt.model, opt.model_z_dim, opt.model_h_dim, opt.model_n_dim,
            opt.model_n_layers, opt.model_nonlin, opt.model_clip_logvar),
        ("{}-bt1{}".format(opt.optimizer, opt.beta1)
         if opt.optimizer in ("adam", "amsgrad")
         else "{}-mt{}".format(opt.optimizer, opt.momentum)),
        "lr{}".format(opt.lr),
        "wa{}{}".format(
            opt.weight_avg,
            "-was{}-wad{}".format(opt.weight_avg_start, opt.weight_avg_decay)
            if opt.weight_avg != "none" else ""),
        "tbs{}".format(opt.train_batch_size),
        "binit{}-bfin{}-bann{:d}".format(
            opt.beta_init, opt.beta_fin,
            int(opt.beta_annealing) if opt.beta_annealing is not None else 0),
        "exp{}".format(opt.exp_num if opt.exp_num else 0),
    ]
    return "-".join(parts)


_Q = "ROADMAP queue 1, "


def _unsupported_flags(opt):
    """The parts of this run the port does not have yet, each with the
    ROADMAP item that ports it."""
    out = []
    if opt.model == "toy-maf":
        out.append(f"toy-maf: {_Q}slice 6 item 14")
    if opt.weight_avg != "none":
        out.append(f"--weight-avg {opt.weight_avg}: {_Q}slice 6 item 14")
    if opt.model_compute_dtype == "bfloat16":
        out.append("bf16 compute: ROADMAP queue 1 (after the fp32 slices)")
    if opt.dp_devices > 1:
        out.append(f"--dp-devices: {_Q}slice 7 item 15")
    return out


def main(argv=None):
    run(argv)
    return 0


def run(argv=None):
    """Train as ``main`` does; returns (TrainState, experiment directory)."""
    opt = build_parser().parse_args(argv)

    from ardae_tpu_torch.cli.common import (
        TOY_DATASETS,
        IndexStream,
        eval_generator,
        evaluate_iwae_vae,
        open_run,
        run_pipeline,
        select_device,
        toy_final_dump,
    )
    from ardae_tpu_torch.core.annealing import annealing_func
    from ardae_tpu_torch.io.logging import logging
    from ardae_tpu_torch.models.registry import build_vae_model
    from ardae_tpu_torch.train.optim import build_optimizer
    from ardae_tpu_torch.train.state import create_train_state
    from ardae_tpu_torch.train.vae_step import VAEStepConfig, train_vae_chunk

    missing = _unsupported_flags(opt)
    if missing:
        raise NotImplementedError("not ported yet: " + "; ".join(missing))
    device = select_device(opt.no_cuda)

    if opt.beta_annealing is None or opt.beta_annealing < 1:
        opt.beta_annealing = None
    run_info = open_run(opt, derive_experiment, device)
    splits = run_info[0]

    model = build_vae_model(
        opt.model, nchannels=opt.nchannels, nheight=opt.nheight,
        z_dim=opt.model_z_dim, h_dim=opt.model_h_dim, n_dim=opt.model_n_dim,
        n_layers=opt.model_n_layers, nonlin=opt.model_nonlin,
        clip_logvar=opt.model_clip_logvar, seed=2 * opt.seed, device=device)
    logging(f"model params: {sum(p.numel() for p in model.parameters()):,}",
            path=opt.path)
    optimizer = build_optimizer(opt.optimizer, model.parameters(), opt.lr,
                                beta1=opt.beta1, momentum=opt.momentum)
    state = create_train_state(model, optimizer)
    cfg = VAEStepConfig(loss_scale=1.0 / float(opt.nchannels * opt.nheight
                                               * opt.nheight))

    def beta_fn(step):
        return annealing_func(opt.beta_init, opt.beta_fin, opt.beta_annealing, step)

    generator = torch.Generator(device=device).manual_seed(opt.seed)
    train_np = splits["train"]
    data_dev = torch.as_tensor(train_np, device=device)
    stream = IndexStream(train_np.shape[0], opt.train_batch_size, seed=opt.seed + 1)
    binarize = bool(splits["info"].get("binarize", False))

    def train_chunk(k):
        return train_vae_chunk(state, cfg, data_dev, stream.take(k), generator,
                               beta_fn, binarize=binarize)

    def evaluate(split, tag):
        elbo, logprob = evaluate_iwae_vae(
            state.model, splits[split], opt.iws_samples,
            eval_generator(opt.seed, tag, device), binarize=binarize,
            batch=opt.eval_batch_size)
        return [("elbo", "elbo", elbo), ("logprob (iws)", "logprob/iws", logprob)]

    def log_train(i_ep, m):
        beta = float(beta_fn(i_ep - 1))
        tail = ("| beta {:5.3f} | loss {:5.4f} | loss (recon) {:5.4f} "
                "| loss (kld) {:5.4f} | elbo {:5.4f} ".format(
                    beta, m["loss"], m["recon_loss"], m["kld_loss"], m["elbo"]))
        return tail, {"model/elbo": m["elbo"], "model/loss": m["loss"],
                      "model/recon": m["recon_loss"], "model/kld": m["kld_loss"],
                      "model/beta": beta}

    def final(writer):
        from ardae_tpu_torch.models.vae.api import generate, reconstruct

        toy_final_dump(opt, state.model, train_np, reconstruct, generate, writer)

    return run_pipeline(opt, state, generator, run_info, train_chunk, evaluate,
                        log_train,
                        final if opt.dataset in TOY_DATASETS else None)


if __name__ == "__main__":
    sys.exit(main())
