"""Baseline (Gaussian-posterior) VAE trainer CLI (JAX twin:
ardae_tpu/cli/vae.py; reference vae.py).

The whole flag surface parses (reference vae.py:28-127) and experiment
names match the JAX driver's. The port trains every baseline name: the
MNIST-family baselines ``mnist``, ``conv``, ``resconv`` and ``resconvct``
and their hierarchical twins ``auxmnist``, ``auxconv``, ``auxresconv`` and
``auxresconvct`` (the aux ELBO and IWAE, models/vae/aux.py) on the MNIST
family and sbMNIST, and ``toy``, ``toy-maf`` (a conditional-MAF posterior,
models/vae/maf.py) and ``auxtoy`` on the toy datasets (swissroll,
25gaussians; a Gaussian likelihood): one optimizer, the loss scaled by
1/(C*H*W) before the backward, beta annealing, and the whole pipeline:
train, the val IWAE eval (exact q) every ``--eval-iws-interval`` steps with
``best-checkpoint`` on improvement, ``checkpoint`` every
``--ckpt-interval`` steps, resume from it, ``--train-mode final``
(train+val up to the best checkpoint's iteration, ``final-checkpoint``),
and the test eval from the best (or final) checkpoint; a toy run ends in
the toy final dump instead (``cli/common.py`` ``toy_final_dump``). Every
``--vis-interval`` steps, and once more before a toy run's dump,
``visualize`` writes the JAX driver's panels to the writer.
``--weight-avg polyak|swa`` keeps an averaged model, which the evals, the
panels and the dump read. The eval and visualization draws come from
generators of their own seeded from (``--seed``, iteration), never from
the training generator. ``--model-compute-dtype bfloat16`` trains in the
JAX driver's mixed precision (models/vae/api.py ``vae_loss``); evaluation,
averaging and checkpoints stay fp32. ``--dp-devices N`` trains on a
data-parallel mesh of N ranks (parallel/, train/vae_step.py; the JAX
driver's checks and log line), rank 0 in this process; no flag is ignored
in silence. ``--dataset`` also takes ``mnist32`` (gray 32 x 32, with
``--nheight 32``), which the JAX package's get_dataset builds and its
parser does not list; at 32 x 32 only the MLP models (``mnist``,
``auxmnist``) run, as in JAX.

Device: ``--no-cuda`` selects the CPU, as in the reference (a mesh's ranks
are then CPU processes); otherwise the run needs a CUDA device a rank and
raises without one.
"""

import argparse
import sys

import numpy as np
import torch


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="swissroll",
                   choices=["swissroll", "25gaussians", "sbmnist", "dbmnist",
                            "dbmnist-val5k", "mnist32"])
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


def main(argv=None):
    run(argv)
    return 0


def run(argv=None):
    """Train as ``main`` does; returns (TrainState, experiment directory),
    rank 0's on a mesh."""
    from ardae_tpu_torch.cli.common import mesh_devices, select_device
    from ardae_tpu_torch.parallel.launch import launch

    argv = list(sys.argv[1:] if argv is None else argv)
    opt = build_parser().parse_args(argv)
    if opt.dp_devices <= 1:
        return _train(opt, select_device(opt.no_cuda))
    # the JAX driver's checks and messages (ardae_tpu/cli/vae.py:278-285)
    if opt.train_batch_size % opt.dp_devices:
        raise SystemExit(f"--train-batch-size {opt.train_batch_size} not "
                         f"divisible by --dp-devices {opt.dp_devices}")
    devices = mesh_devices(opt.no_cuda, opt.dp_devices,
                           "--dp-devices {n} but only {m} devices are available")
    return launch(_rank, devices, argv)[0]


def _rank(device, argv):
    """One rank of a mesh run: rank 0 returns (state, path), the others
    None."""
    from ardae_tpu_torch.cli.common import rank_device
    from ardae_tpu_torch.io.logging import silence
    from ardae_tpu_torch.parallel.mesh import make_mesh

    opt = build_parser().parse_args(argv)
    mesh = make_mesh(opt.dp_devices, device)
    if mesh.rank:
        silence()
    out = _train(opt, rank_device(device), mesh)
    return None if mesh.rank else out


def _train(opt, device, mesh=None):
    """The run on ``device``, one rank of ``mesh`` where given."""
    from ardae_tpu_torch.cli.common import (
        TOY_DATASETS,
        VIS_TAG,
        IndexStream,
        eval_generator,
        evaluate_iwae_vae,
        gt_latent_panel,
        latent_panels,
        open_run,
        run_pipeline,
        toy_final_dump,
        vis_pool,
        write_grid_panels,
        write_toy_panels,
    )
    from ardae_tpu_torch.core.annealing import annealing_func
    from ardae_tpu_torch.io.logging import logging
    from ardae_tpu_torch.models.registry import build_vae_model
    from ardae_tpu_torch.train.optim import build_optimizer
    from ardae_tpu_torch.train.state import create_train_state
    from ardae_tpu_torch.train.vae_step import VAEStepConfig, train_vae_chunk

    if opt.beta_annealing is None or opt.beta_annealing < 1:
        opt.beta_annealing = None
    run_info = open_run(opt, derive_experiment, device, mesh)
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
    state = create_train_state(model, optimizer, weight_avg=opt.weight_avg)
    cfg = VAEStepConfig(loss_scale=1.0 / float(opt.nchannels * opt.nheight
                                               * opt.nheight),
                        compute_dtype=opt.model_compute_dtype,
                        weight_avg=opt.weight_avg,
                        weight_avg_start=opt.weight_avg_start,
                        weight_avg_decay=opt.weight_avg_decay)

    def beta_fn(step):
        return annealing_func(opt.beta_init, opt.beta_fin, opt.beta_annealing, step)

    generator = torch.Generator(device=device).manual_seed(opt.seed)
    train_np = splits["train"]
    data_dev = torch.as_tensor(train_np, device=device)
    stream = IndexStream(train_np.shape[0], opt.train_batch_size, seed=opt.seed + 1)
    binarize = bool(splits["info"].get("binarize", False))

    def train_chunk(k):
        return train_vae_chunk(state, cfg, data_dev, stream.take(k), generator,
                               beta_fn, binarize=binarize, mesh=mesh)

    def evaluate(split, tag):
        elbo, logprob = evaluate_iwae_vae(
            state.eval_model, splits[split], opt.iws_samples,
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

    from ardae_tpu_torch.models.vae import api as vae_api
    from ardae_tpu_torch.utils.visualization import convert_npimage_torchimage

    writer = run_info[4]
    is_toy = opt.dataset in TOY_DATASETS
    gt_latent = gt_latent_panel()

    def visualize(state, i_ep):
        """The JAX driver's panels (ardae_tpu/cli/vae.py:308-374): the
        latent scatter and the ground-truth | latent heatmap, over the whole
        vis pool (on MNIST in chunks of max(bs, 256) rows), and data | recon
        | gen panels: scatter and heatmap on the toy data, sampled and mean
        image grids on MNIST. Every draw comes from the generator of
        (``--seed``, VIS_TAG, i_ep)."""
        model, mode = state.eval_model, opt.train_mode
        gen = eval_generator(opt.seed, (VIS_TAG, i_ep), device)
        with torch.no_grad():
            xs = vis_pool(opt, data_dev, binarize, gen)
            if is_toy:
                gen_x = vae_api.generate(model, xs.shape[0], generator=gen)[0]
                out, _, lat = vae_api.reconstruct(model, xs, generator=gen)
            else:
                n_grid = min(opt.train_batch_size, xs.shape[0])
                out, omu, _ = vae_api.reconstruct(model, xs[:n_grid], generator=gen)
                gen_x, gmu, _ = vae_api.generate(model, n_grid, generator=gen)
                step = max(opt.train_batch_size, 256)
                lat = torch.cat([vae_api.reconstruct(model, xs[lo:lo + step],
                                                     generator=gen)[2]
                                 for lo in range(0, xs.shape[0], step)])
        lat = lat.reshape(xs.shape[0], -1).cpu().numpy()
        if is_toy:
            write_toy_panels(writer, mode, i_ep, xs.cpu(), out.cpu(), gen_x.cpu())
        scatter, latent = latent_panels(lat, 4 if is_toy else 6)
        img = lambda *panels: convert_npimage_torchimage(np.concatenate(panels, axis=1))
        writer.add_image(f"{mode}/latent/scatter", img(scatter), i_ep)
        writer.add_image(f"{mode}/latent/heatmap", img(gt_latent, latent), i_ep)
        if not is_toy:
            write_grid_panels(writer, opt, i_ep, xs[:n_grid], out, omu, gen_x, gmu)
        writer.flush()

    def final(writer):
        toy_final_dump(opt, state.eval_model, train_np, vae_api.reconstruct,
                       vae_api.generate, writer)

    return run_pipeline(opt, state, generator, run_info, train_chunk, evaluate,
                        log_train, visualize, final if is_toy else None, mesh)


if __name__ == "__main__":
    sys.exit(main())
