"""AR-DAE implicit-VAE trainer CLI (JAX twin: ardae_tpu/cli/ivae_ardae.py).

The whole reference flag surface parses (reference ivae_ardae.py:32-196),
and ``--model`` also takes resconv-res3 / resconv-res4, which the JAX
registry builds. The port trains every model name: the resconv models
(the five fc heads, centred or not; the flagship line is resconvct-res),
the implicit-conv line (mnist-conv, which takes ``--model-h-dim 0
--model-n-layers 0``), mnist-concat and the hierarchical aux models
(auxmnist, auxconv, auxresconv(ct) and their -clip twins; their cdae may
take the ``hidden1a`` context, the encoder's std-0 features, and the IWS
eval adds a covariance jitter of 1e-5), each with an mlp-res or mlp-grad
cdae on the MNIST family and sbMNIST, and mlp-concat and auxmlp on the toy
datasets (swissroll, 25gaussians; a Gaussian likelihood); ``--use-kernels``
sends phase A to the hand-written fused DSM kernel of the cdae's style.
``--cdae-compute-dtype bfloat16`` / ``--model-compute-dtype bfloat16``
run phase A / phase B in the JAX driver's mixed precision (bf16 products
on bf16 copies of the fp32 master parameters; train/step.py); the
kernels are fp32 only, so ``--use-kernels`` with a bf16 phase A raises,
while a bf16 phase B keeps them. Evaluation, averaging and checkpoints
stay fp32. The whole pipeline runs: train, the
val IWS eval every ``--eval-iws-interval`` steps with ``best-checkpoint``
on improvement, ``checkpoint`` every ``--ckpt-interval`` steps, resume
from it, ``--train-mode final`` (train+val up to the best checkpoint's
iteration, ``final-checkpoint``), and the test IWS eval from the best (or
final) checkpoint; a toy run ends in the toy final dump instead
(``cli/common.py`` ``toy_final_dump``). Every ``--vis-interval`` steps, and
once more before a toy run's dump, ``visualize`` writes the JAX driver's
panels to the writer. ``--m-weight-avg polyak|swa`` keeps an averaged model,
which the evals, the panels and the dump read. The eval and visualization
draws come from generators of their own, seeded from (``--seed``,
iteration), never from the training generator, so neither the eval or
visualization cadence nor a resume shifts the training noise.
``--dp-devices N`` / ``--sp-devices M`` train on a (data, sample) mesh of
N x M ranks (parallel/, train/step.py; JAX's checks and log line), rank 0
in this process. ``--profile-dir DIR`` writes a ``torch.profiler`` Chrome
trace of the first chunk after iteration 0 into DIR (rank 0's). Jacobian
clamping (``--lmbd-*``) and ``--cdae mlp``, which the JAX driver refuses
too, raise NotImplementedError; no flag is ignored in silence.
``--dataset`` also takes ``mnist32`` (gray 32 x 32, with ``--nheight
32``), which the JAX package's get_dataset builds and its parser does not
list; at 32 x 32 only the MLP models (mnist-concat, auxmnist) run, as in
JAX.

Device: ``--no-cuda`` selects the CPU, as in the reference (a mesh's ranks
are then CPU processes); otherwise the run needs a CUDA device a rank and
raises without one.
"""

import argparse
import os
import sys

import numpy as np
import torch


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="swissroll",
                   choices=["swissroll", "25gaussians", "sbmnist", "dbmnist",
                            "dbmnist-val5k", "mnist32"])
    p.add_argument("--model", default="mlp-concat",
                   choices=["mlp-concat", "mnist-concat", "mnist-conv",
                            "resconv", "resconvct", "resconv-res", "resconvct-res",
                            "resconv-res2", "resconvct-res2", "resconvct-res3",
                            "resconv-res3", "resconv-res4", "resconvct-res4",
                            "auxmlp", "auxmnist", "auxconv",
                            "auxresconv", "auxresconvct", "auxresconv-clip",
                            "auxresconvct-clip"])
    p.add_argument("--model-z-dim", type=int, default=2)
    p.add_argument("--model-h-dim", type=int, default=128)
    p.add_argument("--model-n-dim", type=int, default=2)
    p.add_argument("--model-n-layers", type=int, default=2)
    p.add_argument("--model-nonlin", default="relu")
    p.add_argument("--model-clip-z0-logvar", default="none", choices=["none"])
    p.add_argument("--model-clip-z-logvar", default="none", choices=["none"])
    p.add_argument("--cdae", default="mlp", choices=["mlp", "mlp-res", "mlp-grad"])
    p.add_argument("--cdae-h-dim", type=int, default=128)
    p.add_argument("--cdae-n-layers", type=int, default=2)
    p.add_argument("--cdae-nonlin", default="relu")
    p.add_argument("--cdae-ctx-type", default="data",
                   choices=["data", "lt0", "hidden1a"])
    p.add_argument("--std-scale", type=float, default=1.0)
    p.add_argument("--delta", type=float, default=1.0)
    p.add_argument("--num-cdae-updates", type=int, default=1)
    p.add_argument("--nheight", type=int, default=1)
    p.add_argument("--nchannels", type=int, default=2)
    p.add_argument("--m-lr", type=float, default=0.0001)
    p.add_argument("--d-lr", type=float, default=0.0001)
    p.add_argument("--d-lr-min", type=float, default=0.0001)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--train-batch-size", type=int, default=1024)
    p.add_argument("--eval-batch-size", type=int, default=None)
    p.add_argument("--start-epoch", type=int, default=1)
    p.add_argument("--start-batch-idx", type=int, default=0)
    p.add_argument("--train-nz-cdae", type=int, default=1)
    p.add_argument("--train-nz-model", type=int, default=1)
    p.add_argument("--train-nstd-cdae", type=int, default=1)
    p.add_argument("--m-optimizer", default="adam",
                   choices=["sgd", "adam", "amsgrad", "rmsprop"])
    p.add_argument("--m-beta1", type=float, default=0.5)
    p.add_argument("--m-momentum", type=float, default=0.5)
    p.add_argument("--d-optimizer", default="adam",
                   choices=["sgd", "adam", "amsgrad", "rmsprop"])
    p.add_argument("--d-beta1", type=float, default=0.5)
    p.add_argument("--d-momentum", type=float, default=0.5)
    p.add_argument("--beta-init", type=float, default=1.0)
    p.add_argument("--beta-fin", type=float, default=1.0)
    p.add_argument("--beta-annealing", type=float, default=None)
    p.add_argument("--eta-init", type=float, default=0.0)
    p.add_argument("--eta-fin", type=float, default=0.0)
    p.add_argument("--eta-annealing", type=float, default=None)
    p.add_argument("--lmbd-init", type=float, default=0.0)
    p.add_argument("--lmbd-fin", type=float, default=0.0)
    p.add_argument("--lmbd-annealing", type=float, default=None)
    p.add_argument("--iws-samples", type=int, default=512)
    p.add_argument("--m-weight-avg", default="none",
                   choices=["none", "swa", "polyak"])
    p.add_argument("--m-weight-avg-start", type=int, default=1000)
    p.add_argument("--m-weight-avg-decay", type=float, default=0.998)
    p.add_argument("--train-mode", default="train", choices=["train", "final"])
    p.add_argument("--no-cuda", action="store_true", default=False)
    p.add_argument("--log-interval", type=int, default=100)
    p.add_argument("--vis-interval", type=int, default=1000)
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
                   help="skip the post-training test-set IWS eval")
    p.add_argument("--cdae-compute-dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--model-compute-dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--use-kernels", action="store_true", default=False,
                   help="phase-A DSM loss through the hand-written fused "
                        "Hopper kernel of the cdae's style (ops/fused_dsm for "
                        "mlp-res, ops/fused_dsm_grad for mlp-grad); raises on "
                        "a config the kernel does not cover")
    p.add_argument("--dp-devices", type=int, default=0)
    p.add_argument("--sp-devices", type=int, default=0)
    p.add_argument("--profile-dir", default=None)
    return p


def derive_experiment(opt):
    """Config-as-string experiment identity (reference ivae_ardae.py:212-262)."""
    parts = [
        "m{}-mz{}-mh{}-mn{}-mnh{}-ma{}".format(
            opt.model, opt.model_z_dim, opt.model_h_dim, opt.model_n_dim,
            opt.model_n_layers,
            "sfp" if opt.model_nonlin == "softplus" else opt.model_nonlin),
        "d{}-dh{}-dnh{}-da{}-dct{}".format(
            opt.cdae, opt.cdae_h_dim, opt.cdae_n_layers,
            "sfp" if opt.cdae_nonlin == "softplus" else opt.cdae_nonlin,
            opt.cdae_ctx_type),
        ("m{}-bt1{}".format(opt.m_optimizer, opt.m_beta1)
         if opt.m_optimizer in ("adam", "amsgrad")
         else "m{}-mt{}".format(opt.m_optimizer, opt.m_momentum)),
        "mlr{}".format(opt.m_lr),
        ("d{}-bt1{}".format(opt.d_optimizer, opt.d_beta1)
         if opt.d_optimizer in ("adam", "amsgrad")
         else "d{}-mt{}".format(opt.d_optimizer, opt.d_momentum)),
        "dlr{}".format(opt.d_lr),
        "tbs{}".format(opt.train_batch_size),
        "nd{}".format(opt.num_cdae_updates),
        "mwa{}{}".format(
            opt.m_weight_avg,
            "-was{}-wad{}".format(opt.m_weight_avg_start, opt.m_weight_avg_decay)
            if opt.m_weight_avg != "none" else ""),
        "binit{}-bfin{}-bann{:d}".format(
            opt.beta_init if opt.beta_init != opt.beta_fin else 1.0,
            opt.beta_fin,
            int(opt.beta_annealing)
            if opt.beta_annealing is not None and opt.beta_init != opt.beta_fin
            else 0),
        "ssc{}".format(opt.std_scale),
        "del{}".format(opt.delta),
        "nzc{}{}".format(
            opt.train_nz_cdae,
            "-nzs{}".format(opt.train_nstd_cdae) if opt.train_nstd_cdae > 1 else ""),
        "nzm{}".format(opt.train_nz_model),
        "{}".format(opt.exp_num if opt.exp_num else 0),
    ]
    return "-".join(parts)


def _unsupported_flags(opt):
    """The flags of this run that the JAX driver refuses too."""
    out = []
    if opt.lmbd_init != 0.0 or opt.lmbd_fin != 0.0:
        out.append("jacobian clamping (--lmbd-*) is dormant in the reference "
                   "too: every model's jac_clamping_loss raises")
    if opt.cdae == "mlp":
        out.append("--cdae mlp (legacy reconstruction DAE) is unused by the "
                   "reference driver; use mlp-res or mlp-grad")
    return out


def main(argv=None):
    run(argv)
    return 0


def _mesh_shape(opt):
    """(dp, sp) of the run, with the JAX driver's checks and messages
    (ardae_tpu/cli/ivae_ardae.py:378-390); (1, 1) on one device."""
    dp = opt.dp_devices if opt.dp_devices > 1 else 0
    sp = opt.sp_devices if opt.sp_devices > 1 else 0
    if not (dp or sp):
        return 1, 1
    n_dp = dp or 1
    if opt.train_batch_size % n_dp:
        raise SystemExit(f"--train-batch-size {opt.train_batch_size} not "
                         f"divisible by --dp-devices {opt.dp_devices}")
    if sp and opt.train_nz_cdae % sp:
        raise SystemExit(f"--train-nz-cdae {opt.train_nz_cdae} not divisible "
                         f"by --sp-devices {sp}")
    return n_dp, sp or 1


def run(argv=None):
    """Train as ``main`` does; returns (TrainState, experiment directory),
    rank 0's on a mesh."""
    from ardae_tpu_torch.cli.common import mesh_devices, select_device
    from ardae_tpu_torch.parallel.launch import launch

    argv = list(sys.argv[1:] if argv is None else argv)
    opt = build_parser().parse_args(argv)
    missing = _unsupported_flags(opt)
    if missing:
        raise NotImplementedError("refused, as by the JAX driver: "
                                  + "; ".join(missing))
    dp, sp = _mesh_shape(opt)
    if dp * sp == 1:
        return _train(opt, select_device(opt.no_cuda))
    devices = mesh_devices(opt.no_cuda, dp * sp,
                           "mesh needs {n} devices but only {m} are available")
    return launch(_rank, devices, argv, dp, sp)[0]


def _rank(device, argv, dp, sp):
    """One rank of a mesh run: rank 0 returns (state, path), the others
    None."""
    from ardae_tpu_torch.cli.common import rank_device
    from ardae_tpu_torch.io.logging import silence
    from ardae_tpu_torch.parallel.mesh import sample_parallel_mesh

    mesh = sample_parallel_mesh(dp, sp, device)
    if mesh.rank:
        silence()
    out = _train(build_parser().parse_args(argv), rank_device(device), mesh)
    return None if mesh.rank else out


def _profiled(opt, device, chunk, i_ep, k):
    """``chunk()`` under torch.profiler (the CPU, and the card's kernels on
    a card), its Chrome trace written into ``--profile-dir`` (JAX
    cli/ivae_ardae.py:529-545)."""
    from torch.profiler import ProfilerActivity, profile

    from ardae_tpu_torch.io.logging import logging

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        metrics = chunk()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    os.makedirs(opt.profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        opt.profile_dir, f"iter{i_ep + 1}-{i_ep + k}.trace.json"))
    logging(f"profiler trace written to {opt.profile_dir}", path=opt.path)
    return metrics


def _train(opt, device, mesh=None):
    """The run on ``device``, one rank of ``mesh`` where given."""
    from ardae_tpu_torch.cli.common import (
        TOY_DATASETS,
        VIS_TAG,
        IndexStream,
        eval_generator,
        evaluate_iws_ivae,
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
    from ardae_tpu_torch.models.registry import (
        build_cdae,
        build_ivae_model,
        context_dim_for,
    )
    from ardae_tpu_torch.train.optim import build_optimizer
    from ardae_tpu_torch.train.state import create_train_state
    from ardae_tpu_torch.train.step import StepConfig, train_chunk

    for name in ("beta_annealing", "eta_annealing", "lmbd_annealing"):
        v = getattr(opt, name)
        if v is None or v < 1:
            setattr(opt, name, None)
    run_info = open_run(opt, derive_experiment, device, mesh)
    splits = run_info[0]

    model = build_ivae_model(
        opt.model, nchannels=opt.nchannels, nheight=opt.nheight,
        z_dim=opt.model_z_dim, h_dim=opt.model_h_dim, n_dim=opt.model_n_dim,
        n_layers=opt.model_n_layers, nonlin=opt.model_nonlin,
        seed=2 * opt.seed, device=device)
    ctx_dim = context_dim_for(
        opt.cdae_ctx_type, model_name=opt.model, nchannels=opt.nchannels,
        nheight=opt.nheight, z_dim=opt.model_z_dim, h_dim=opt.model_h_dim)
    cdae = build_cdae(opt.cdae, input_dim=opt.model_z_dim, context_dim=ctx_dim,
                      h_dim=opt.cdae_h_dim, n_layers=opt.cdae_n_layers,
                      nonlin=opt.cdae_nonlin, seed=2 * opt.seed + 1,
                      device=device)
    logging(f"model params: {sum(p.numel() for p in model.parameters()):,}",
            path=opt.path)
    logging(f"cdae params: {sum(p.numel() for p in cdae.parameters()):,} | "
            f"context {opt.cdae_ctx_type}, {ctx_dim} wide", path=opt.path)

    # reference quirk: the model's rmsprop takes d_momentum (ivae_ardae.py:554)
    opt_m = build_optimizer(opt.m_optimizer, model.parameters(), opt.m_lr,
                            beta1=opt.m_beta1, momentum=opt.d_momentum)
    opt_d = build_optimizer(opt.d_optimizer, cdae.parameters(), opt.d_lr,
                            beta1=opt.d_beta1, momentum=opt.d_momentum)
    state = create_train_state(model, opt_m, cdae, opt_d,
                               weight_avg=opt.m_weight_avg)
    cfg = StepConfig(
        std_scale=opt.std_scale, delta=opt.delta,
        num_cdae_updates=opt.num_cdae_updates,
        train_nz_cdae=opt.train_nz_cdae, train_nstd_cdae=opt.train_nstd_cdae,
        train_nz_model=opt.train_nz_model, ctx_type=opt.cdae_ctx_type,
        use_kernels=opt.use_kernels,
        cdae_compute_dtype=opt.cdae_compute_dtype,
        model_compute_dtype=opt.model_compute_dtype,
        weight_avg=opt.m_weight_avg,
        weight_avg_start=opt.m_weight_avg_start,
        weight_avg_decay=opt.m_weight_avg_decay)
    if opt.train_nz_cdae < 2:
        logging("| warning: --train-nz-cdae < 2 makes the per-item sigma "
                "estimate (sample std over nz) NaN, as in the reference; use "
                "--train-nz-cdae >= 2.", path=opt.path)

    def beta_fn(step):
        return annealing_func(opt.beta_init, opt.beta_fin, opt.beta_annealing, step)

    generator = torch.Generator(device=device).manual_seed(opt.seed)

    train_np = splits["train"]
    data_dev = torch.as_tensor(train_np, device=device)
    stream = IndexStream(train_np.shape[0], opt.train_batch_size, seed=opt.seed + 1)
    binarize = bool(splits["info"].get("binarize", False))

    profile = [opt.profile_dir is not None and (mesh is None or mesh.rank == 0)]

    def train(k):
        c_idx = stream.take(k * opt.num_cdae_updates).reshape(
            k, opt.num_cdae_updates, opt.train_batch_size)
        m_idx = stream.take(k)
        chunk = lambda: train_chunk(state, cfg, data_dev, c_idx, m_idx, generator,
                                    beta_fn, binarize=binarize, mesh=mesh)
        if not (profile[0] and state.step > 0):
            return chunk()
        # once: the first chunk after iteration 0 (JAX: i_ep > 0)
        profile[0] = False
        return _profiled(opt, device, chunk, state.step, k)

    # the aux models' covariance jitter (JAX cli/ivae_ardae.py:408)
    jitter = 1e-5 if model.family == "aux" else 0.0

    def evaluate(split, tag):
        logprob = evaluate_iws_ivae(
            state.eval_model, splits[split], opt.iws_samples,
            eval_generator(opt.seed, tag, device), binarize=binarize,
            batch=opt.eval_batch_size, jitter=jitter)
        return [("logprob (iws)", "logprob/iws", logprob)]

    def log_train(i_ep, m):
        beta = float(beta_fn(i_ep - 1))
        std_true = m["std_eff_mean"] / opt.std_scale
        tail = ("| dlr {:.5f} | (eff) std {:5.3f} | (true) std {:5.3f} "
                "| (eff) max std {:5.3f} | (eff) min std {:5.3f} "
                "| beta {:5.3f} | loss (vae) {:5.3f} | loss (recon) {:5.3f} "
                "| loss (prior) {:5.3f} | loss (cdae) {:5.4f} ".format(
                    opt.d_lr, m["std_eff_mean"], std_true, m["std_eff_max"],
                    m["std_eff_min"], beta, m["model_loss"], m["recon_loss"],
                    m["prior_loss"], m["cdae_loss"]))
        return tail, {
            "model/loss": m["model_loss"], "model/recon": m["recon_loss"],
            "model/prior": m["prior_loss"], "model/beta": beta,
            "cdae/loss": m["cdae_loss"], "cdae/std/eff/mean": m["std_eff_mean"],
            "cdae/std/true/mean": std_true, "cdae/std/eff/max": m["std_eff_max"],
            "cdae/std/eff/min": m["std_eff_min"], "cdae/lr": opt.d_lr}

    from ardae_tpu_torch.models.ivae import api as ivae_api
    from ardae_tpu_torch.utils.visualization import convert_npimage_torchimage

    writer = run_info[4]
    is_toy = opt.dataset in TOY_DATASETS
    gt_latent = gt_latent_panel()

    def visualize(state, i_ep):
        """The JAX driver's panels (ardae_tpu/cli/ivae_ardae.py:424-507):
        logvar_qz scalars and histograms from 64 draws of 256 items (its
        item-indexed tags), the latent scatter and heatmaps from 4,096 items
        at noise scales None / 0.8 / 0.5 / 0.1 / 0 (one draw, scaled), and
        data | recon | gen panels: scatter and heatmap on the toy data,
        sampled and mean image grids on MNIST. Every draw comes from the
        generator of (``--seed``, VIS_TAG, i_ep)."""
        model, mode = state.eval_model, opt.train_mode
        gen = eval_generator(opt.seed, (VIS_TAG, i_ep), device)
        with torch.no_grad():
            xs = vis_pool(opt, data_dev, binarize, gen)
            x_lat = xs[:4096]
            eps = ivae_api.make_eps(model, x_lat.shape[0], 1, generator=gen,
                                    device=device)
            lat = {lbl: ivae_api.sample_latents(model, x_lat, 1, noise_std=s, eps=eps)
                   .reshape(-1, opt.model_z_dim).cpu().numpy()
                   for lbl, s in (("", None), ("08", 0.8), ("05", 0.5),
                                  ("01", 0.1), ("0", 0.0))}
            z = ivae_api.sample_latents(model, xs[:256], 64, generator=gen)
            logvar_qz = np.log(np.var(z.cpu().numpy(), axis=1) + 1e-10)
            if is_toy:
                gen_x = ivae_api.generate(model, xs.shape[0], generator=gen)[0]
                out = ivae_api.reconstruct(model, xs, generator=gen)[0]
            else:
                n_grid = min(opt.train_batch_size, xs.shape[0])
                out, omu, _ = ivae_api.reconstruct(model, xs[:n_grid], generator=gen)
                gen_x, gmu, _ = ivae_api.generate(model, n_grid, generator=gen)
        writer.add_scalar(f"{mode}/enc/logvar_qz/mean/step",
                          float(logvar_qz.mean()), i_ep)
        writer.add_scalar(f"{mode}/enc/logvar_qz/median/step",
                          float(np.median(logvar_qz)), i_ep)
        writer.add_histogram(f"{mode}/enc/logvar_qz/hist/step",
                             logvar_qz.reshape(-1), i_ep)
        for ii in range(min(2, logvar_qz.shape[0])):
            # the JAX driver's tag, "train" prefix and all
            writer.add_histogram(f"train{mode}/enc/logvar_qz/hist/item{ii}/step",
                                 logvar_qz[ii], i_ep)
        val = 4 if is_toy else 6
        scatter, latent = latent_panels(lat[""], val)
        img = lambda *panels: convert_npimage_torchimage(np.concatenate(panels, axis=1))
        writer.add_image(f"{mode}/latent/scatter", img(scatter), i_ep)
        writer.add_image(f"{mode}/gt_latent/heatmap", img(gt_latent, latent), i_ep)
        writer.add_image(f"{mode}/latent/heatmap", img(latent), i_ep)
        stds = [latent_panels(lat[s], val)[1] for s in ("08", "05", "01", "0")]
        writer.add_image(f"{mode}/alllatent/heatmap",
                         img(gt_latent, latent, *stds), i_ep)
        if is_toy:
            gen_heat = write_toy_panels(writer, mode, i_ep, xs.cpu(), out.cpu(),
                                        gen_x.cpu())
            # the JAX driver writes this tag whatever the mode
            writer.add_image("train/gen/heatmap", img(gen_heat), i_ep)
        else:
            write_grid_panels(writer, opt, i_ep, xs[:n_grid], out, omu, gen_x, gmu)
        writer.flush()

    def final(writer):
        toy_final_dump(opt, state.eval_model, train_np, ivae_api.reconstruct,
                       ivae_api.generate, writer)

    return run_pipeline(opt, state, generator, run_info, train, evaluate,
                        log_train, visualize, final if is_toy else None, mesh)


if __name__ == "__main__":
    sys.exit(main())
