"""Driver plumbing shared by both drivers (JAX twin:
ardae_tpu/cli/common.py): the device, experiment naming and resume
directory, the train / eval / checkpoint pipeline, the host index stream,
chunk boundaries, the eval generators, the IWS evaluation of an implicit VAE,
the IWAE evaluation of a baseline VAE over a split, and the toy final
dump."""

import datetime
import glob
import math
import os
import time

import numpy as np
import torch

from ardae_tpu_torch import data
from ardae_tpu_torch.io.checkpoint import load_checkpoint, load_end_iter
from ardae_tpu_torch.io.logging import get_time, logging, make_writer

TEST_EVAL_TAG = 999_983  # the test eval's generator tag (JAX: fold_in(k_eval, 999_983))
DUMP_TAG = 999_979       # the toy final dump's (JAX: fold_in(k_eval, 999_979))
DUMP_CHUNK = 131_072     # rows of the toy final dump a chunk
TOY_DATASETS = ("swissroll", "25gaussians")


def select_device(no_cuda):
    """The CPU under ``--no-cuda``, as in the reference; otherwise the card,
    with TF32 off (the reference trains and evaluates in full fp32; cuDNN
    would run convolutions in TF32 by default, and the IWS covariance feeds
    a Cholesky). Raises without a card."""
    if no_cuda:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --no-cuda to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def eval_generator(seed, tag, device):
    """The generator of one eval, seeded from (seed, tag): the val eval at
    iteration i takes tag i, the test eval TEST_EVAL_TAG."""
    state = np.random.SeedSequence([seed, tag]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def open_run(opt, derive_experiment, device):
    """The set-up both drivers share, in this order: the dataset (final mode
    folds val into train), the iteration count, the experiment directory
    (the latest matching one under ``--resume``, else a new one), final
    mode's end iteration, the refusal of a visualization cadence the run
    would reach, and the log's header. Sets ``opt.path``,
    ``opt.experiment`` and ``opt.best_val_loss`` (None). Returns (splits,
    steps per epoch, total iterations, end iteration or None, writer)."""
    opt.best_val_loss = None
    final_mode = opt.train_mode == "final"
    # data first: the iteration count decides whether the run reaches the
    # visualization cadence
    splits = data.get_dataset(opt.dataset, root=opt.data_root,
                              final_mode=final_mode,
                              toy_sizes=toy_sizes(opt.toy_train_size))
    steps_per_epoch = splits["train"].shape[0] // opt.train_batch_size
    total_iters = opt.epochs * steps_per_epoch
    if opt.max_iters is not None:
        total_iters = min(total_iters, opt.max_iters)

    if opt.cache is None:
        opt.cache = "experiments"
    if opt.experiment is None:
        opt.experiment = derive_experiment(opt)
    opt.path = resolve_experiment_path(opt.cache, opt.experiment, opt.resume)
    end_iter = load_end_iter(opt.path, "best-checkpoint") if final_mode else None
    reach = total_iters if end_iter is None else min(total_iters, end_iter)
    if 0 < opt.vis_interval <= reach:
        raise NotImplementedError(
            f"not ported yet: visualization (--vis-interval {opt.vis_interval}): "
            "ROADMAP queue 1, slice 6 item 14")
    logging(str(opt), path=opt.path)
    writer = make_writer(opt.path)
    if opt.dataset in TOY_DATASETS:
        logging(f"dataset {opt.dataset}: generated from seed "
                f"{data.toy.SEED}, cached under {opt.data_root}/toy",
                path=opt.path)
    elif splits["info"].get("synthetic"):
        logging(f"dataset {opt.dataset}: SYNTHETIC surrogate (no real files "
                f"under {opt.data_root})", path=opt.path)
    else:
        logging(f"dataset {opt.dataset}: real files from {opt.data_root}",
                path=opt.path)
    logging(f"device: {device}"
            + (f" ({torch.cuda.get_device_name(device)})"
               if device.type == "cuda" else ""), path=opt.path)
    return splits, steps_per_epoch, total_iters, end_iter, writer


def toy_sizes(train_size):
    """The toy splits for ``--toy-train-size`` (JAX cli/ivae_ardae.py:
    257-263): None, the defaults, at 2,000,000; else test = max(n / 100,
    1000) and val = max(n / 1000, 500)."""
    if train_size == 2_000_000:
        return None
    return dict(train=train_size, test=max(train_size // 100, 1000),
                val=max(train_size // 1000, 500))


def resume_run(state, opt, flavor, generator):
    """Load ``flavor`` into ``state`` and the training ``generator`` if it
    exists and set ``opt.best_val_loss`` from it; returns the iteration to
    go on from (0 without a checkpoint)."""
    restored = load_checkpoint(state, opt.path, flavor, generator)
    if restored is None:
        return 0
    meta = restored[1]
    best = float(meta["best_val_loss"])
    opt.best_val_loss = None if best == -math.inf else best
    logging(f"| resumed from {flavor} at iter {int(meta['i_ep'])}", path=opt.path)
    return int(meta["i_ep"])


def run_pipeline(opt, state, generator, run, train_chunk, evaluate, log_train,
                 final=None):
    """The pipeline both drivers share once their state is built: resume
    from ``checkpoint`` (``final-checkpoint`` in final mode), train in
    chunks that end at every cadence boundary, log, halt on a NaN/Inf
    metric at log time, the val eval with ``best-checkpoint`` on
    improvement, ``checkpoint`` every ``--ckpt-interval`` steps, final
    mode's stop at the best iteration, and the test eval from
    ``best-checkpoint`` (or ``final-checkpoint``). Returns (state,
    experiment directory); the state is the one the test eval loaded.

    ``run``: what ``open_run`` returned. ``train_chunk(k)`` trains k steps
    and returns the last step's metrics. ``evaluate(split, tag)`` returns
    the split's bounds as [(label, scalar name, value)], the last of them
    the one that picks ``best-checkpoint``. ``log_train(i_ep, metrics)``
    returns the train line's tail and its scalars {name: value}.
    ``final(writer)``, where given, takes the test eval's place (the toy
    final dump), on the live state."""
    from ardae_tpu_torch.io.checkpoint import save_checkpoint

    splits, steps_per_epoch, total_iters, end_iter, writer = run
    final_mode = opt.train_mode == "final"
    prefix = "final-" if final_mode else ""
    i_ep = resume_run(state, opt, f"{prefix}checkpoint", generator)

    def save(flavor):
        t0 = time.time()
        meta = checkpoint_meta(i_ep, steps_per_epoch, opt.best_val_loss)
        save_checkpoint(state, meta, opt.path, flavor, generator)
        logging(f"| saved {flavor} at iter {i_ep} ({time.time() - t0:.2f} s)",
                path=opt.path)

    def timed_eval(split, tag):
        t0 = time.time()
        bounds = evaluate(split, tag)
        text = " | ".join(f"{label} {v:.4f}" for label, _, v in bounds)
        return bounds, f"| sec/step {time.time() - t0:5.2f} | {text} "

    def banner(line):
        logging("-" * 89, path=opt.path)
        logging(line, path=opt.path)
        logging("-" * 89, path=opt.path)

    start_time = time.time()
    try:
        while i_ep < total_iters:
            if final_mode and i_ep >= end_iter:
                raise EndIterError
            k = min(total_iters - i_ep, chunk_until_boundary(
                i_ep, [opt.log_interval, opt.vis_interval,
                       opt.eval_iws_interval, opt.ckpt_interval],
                end_iter=end_iter))
            metrics = train_chunk(k)
            i_ep += k
            epoch = (i_ep - 1) // steps_per_epoch + 1
            batch_idx = (i_ep - 1) % steps_per_epoch + 1
            if i_ep % opt.log_interval == 0:
                m = {kk: float(v) for kk, v in metrics.items()}
                if not all(np.isfinite(v) for v in m.values()):
                    logging("| NaN/Inf training metrics at iter "
                            f"{i_ep} — halting training early (best "
                            "checkpoint preserved; the test eval reloads it): "
                            + ", ".join(f"{kk}={vv}" for kk, vv in m.items()),
                            path=opt.path)
                    break
                tail, scalars = log_train(i_ep, m)
                ms = (time.time() - start_time) * 1000 / opt.log_interval
                logging("| iter {:d} | epoch {:3d} | {:5d}/{:5d} | ms/step {:5.2f} "
                        .format(i_ep, epoch, batch_idx, steps_per_epoch, ms) + tail,
                        path=opt.path)
                for name, v in scalars.items():
                    writer.add_scalar(f"{opt.train_mode}/{name}/step", v, i_ep)
                start_time = time.time()

            t_side = time.time()
            if (not final_mode and opt.eval_iws_interval > 0
                    and i_ep % opt.eval_iws_interval == 0):
                bounds, text = timed_eval("val", i_ep)
                for _, name, v in bounds:
                    writer.add_scalar(f"val/{name}/step", v, i_ep)
                banner("| val       | iter {:d} | epoch {:3d} | {:5d}/{:5d} ".format(
                    i_ep, epoch, batch_idx, steps_per_epoch) + text)
                logprob = bounds[-1][2]
                if opt.best_val_loss is None or logprob > opt.best_val_loss:
                    opt.best_val_loss = logprob
                    save("best-checkpoint")
            if opt.ckpt_interval > 0 and i_ep % opt.ckpt_interval == 0:
                save(f"{prefix}checkpoint")
            # eval and checkpoint time stays out of the next ms/step
            start_time += time.time() - t_side

    except KeyboardInterrupt:
        banner("Exiting from training early")
        writer.close()
        return state, opt.path
    except EndIterError:
        save(f"{prefix}checkpoint")
        writer.flush()
        banner("End of training (final)")

    if opt.skip_final_test_eval:
        logging("| skipping final test eval (--skip-final-test-eval)",
                path=opt.path)
    elif final is not None:
        final(writer)
    else:
        flavor = f"{prefix}checkpoint" if final_mode else "best-checkpoint"
        if load_checkpoint(state, opt.path, flavor) is None:
            # e.g. a NaN halt before the first eval: no best checkpoint was
            # written, so the numbers below are the live state's
            logging(f"| warning: no {flavor} on disk — evaluating the live "
                    "train state instead", path=opt.path)
        bounds, text = timed_eval("test", TEST_EVAL_TAG)
        for _, name, v in bounds:
            writer.add_scalar(f"test/{name}/step", v, 0)
        banner("| test       " + text)
    writer.close()
    return state, opt.path


def checkpoint_meta(i_ep, steps_per_epoch, best_val_loss):
    """A checkpoint's meta after ``i_ep`` iterations; -inf for no best
    bound yet."""
    return {
        "i_ep": i_ep,
        "epoch": i_ep // steps_per_epoch + 1,
        "batch_idx": i_ep % steps_per_epoch,
        "train_num_iters_per_epoch": steps_per_epoch,
        "best_val_loss": best_val_loss if best_val_loss is not None else -math.inf,
    }


def resolve_experiment_path(cache, experiment, resume):
    """Timestamped experiment dir; resume picks the latest matching one
    (any '-YYMMDD-HH:MM:SS' suffix; the reference's '-19*'/'-20*' glob stops
    matching from 2021 on, a documented reference bug)."""
    base = os.path.join(cache, experiment)
    path = None
    if resume:
        listing = []
        for p in glob.glob(base + "-[0-9][0-9]*"):
            try:
                listing.append(
                    (datetime.datetime.strptime(p, base + "-%y%m%d-%H:%M:%S"), p))
            except ValueError:
                continue
        if listing:
            path = max(listing)[1]
    if path is None:
        path = f"{base}-{get_time()}"
    os.makedirs(path, exist_ok=True)
    return path


class IndexStream:
    """Host-side shuffled-epoch batch-index stream (drop-remainder); only
    index arrays cross to the device, where the rows live."""

    def __init__(self, n, batch_size, seed=0):
        if n < batch_size:
            raise ValueError(
                f"dataset size {n} < batch size {batch_size}: no full batch "
                "exists under drop-remainder semantics (reduce the batch "
                "size or raise --toy-train-size)")
        self.n = n
        self.bs = batch_size
        self.per_epoch = n // batch_size
        self._rng = np.random.default_rng(seed)
        self._perm = self._rng.permutation(n)
        self._pos = 0

    def take(self, k):
        """(k, bs) int64 of k consecutive shuffled batches."""
        out = np.empty((k, self.bs), np.int64)
        for i in range(k):
            if self._pos + self.bs > self.per_epoch * self.bs:
                self._perm = self._rng.permutation(self.n)
                self._pos = 0
            out[i] = self._perm[self._pos : self._pos + self.bs]
            self._pos += self.bs
        return out


def chunk_until_boundary(i_ep, intervals, end_iter=None, max_chunk=200):
    """Largest k such that no cadence boundary falls strictly inside
    (i_ep, i_ep + k): boundaries happen when (i_ep + j) % interval == 0."""
    k = max_chunk
    for interval in intervals:
        if interval and interval > 0:
            k = min(k, interval - (i_ep % interval))
    if end_iter is not None:
        k = min(k, max(1, end_iter - i_ep))
    return max(1, k)


def default_eval_batch(iws_samples):
    """Items per eval batch when the driver is given none: at most 2**25
    decoder pixels, at most 128 items."""
    return max(1, min(128, (1 << 25) // (iws_samples * 28 * 28)))


def _eval_batches(model, eval_data, batch, binarize, generator, draws):
    """(x, that batch's injected draws) over the split, each batch
    binarized anew with its own uniforms ``draws[i]["bin"]`` or the
    generator's."""
    device = next(model.parameters()).device
    rows = torch.as_tensor(eval_data, device=device)
    for i, start in enumerate(range(0, rows.shape[0], batch)):
        d = draws[i] if draws else {}
        x = rows[start:start + batch]
        if binarize:
            u = d.get("bin")
            if u is None:
                u = torch.rand(x.shape, generator=generator, device=device)
            x = (u.to(device) < x).to(torch.float32)
        yield x, d


def evaluate_iws_ivae(model, eval_data, iws_samples, generator=None,
                      binarize=False, batch=None, jitter=0.0, draws=None):
    """Mean IWS log-likelihood over an eval split (reference
    ivae_ardae.py:644-673), without autograd.

    The bound is per item, so the grouping ``batch`` does not change the
    math; None picks ``default_eval_batch(iws_samples)`` items. The tail
    batch is simply shorter. A dynamically binarized split draws each
    batch's pixels anew. ``draws``: optional per-batch list of {"bin": (nv,
    D) uniforms, "eps": (nv*ssz, noise_dim), "new_eps": (nv, ssz, z_dim)};
    otherwise every draw comes from ``generator``."""
    from ardae_tpu_torch.models.ivae.api import logprob_iws

    sums = []
    with torch.no_grad():
        for x, d in _eval_batches(model, eval_data,
                                  batch or default_eval_batch(iws_samples),
                                  binarize, generator, draws):
            per_item = logprob_iws(model, x, iws_samples, jitter=jitter,
                                   reduce="per_item", generator=generator,
                                   eps=d.get("eps"), new_eps=d.get("new_eps"))
            sums.append(torch.sum(per_item))
    return _mean(sums, len(eval_data))


def evaluate_iwae_vae(model, eval_data, iws_samples, generator=None,
                      binarize=False, batch=None, draws=None):
    """(elbo, logprob) of a baseline VAE over an eval split, each the mean
    of its per-item values (reference vae.py:345-377), without autograd:
    the exact-q IWAE bound and -vae_loss at beta 1, each from its own
    draws. Batching as in ``evaluate_iws_ivae``. ``draws``: optional
    per-batch list of {"bin": (nv, D) uniforms, "iwae_eps": (nv, ssz,
    z_dim), "elbo_eps": (nv, z_dim)}; otherwise every draw comes from
    ``generator``, in that order."""
    from ardae_tpu_torch.models.vae.api import logprob_iwae, vae_loss

    lps, losses = [], []
    with torch.no_grad():
        for x, d in _eval_batches(model, eval_data,
                                  batch or default_eval_batch(iws_samples),
                                  binarize, generator, draws):
            lps.append(torch.sum(logprob_iwae(
                model, x, iws_samples, reduce="per_item", generator=generator,
                eps=d.get("iwae_eps"))))
            losses.append(torch.sum(vae_loss(
                model, x, reduce="per_item", generator=generator,
                eps=d.get("elbo_eps"))[0]))
    n = len(eval_data)
    return -_mean(losses, n), _mean(lps, n)


def _mean(sums, n):
    """The mean over n items of per-batch sums, added in float64."""
    total = float(torch.stack(sums).double().sum()) if sums else 0.0
    return total / max(n, 1)


def toy_final_dump(opt, model, train_np, reconstruct, generate, writer):
    """The toy runs' end (JAX cli/ivae_ardae.py:638-667, cli/vae.py:
    473-499): the first min(1,000,000, n_train) training points in chunks
    of DUMP_CHUNK rows (the last chunk is whole, as in JAX), each
    reconstructed and as many points generated, without autograd, every
    draw from the generator seeded from (``--seed``, DUMP_TAG). Writes the
    data | recon | gen heatmaps (over [-6, 6]^2) and the ground-truth |
    latent heatmaps (over [-4, 4]^2), 256 bins each, to the writer and to
    ``toy-dump.npz`` in the experiment directory (the panels and the four
    count grids), and logs the rows and how many values are not finite.
    The JAX drivers draw the periodic visualization's panels first; those
    wait with it (ROADMAP queue 1, slice 6 item 14). Returns the dumped
    (data, recon, gen, latent) arrays."""
    from ardae_tpu_torch.core.energy import normal_energy_func
    from ardae_tpu_torch.utils import visualization as vis

    t0 = time.time()
    device = next(model.parameters()).device
    gen = eval_generator(opt.seed, DUMP_TAG, device)
    parts = {k: [] for k in ("data", "recon", "gen", "latent")}
    with torch.no_grad():
        for lo in range(0, min(1_000_000, len(train_np)), DUMP_CHUNK):
            xs = torch.as_tensor(train_np[lo:lo + DUMP_CHUNK], device=device)
            out, _, z = reconstruct(model, xs, generator=gen)
            sample, _, _ = generate(model, xs.shape[0], generator=gen)
            for k, v in (("data", xs), ("recon", out), ("gen", sample),
                         ("latent", z)):
                parts[k].append(v.cpu().numpy())
    arrays = {k: np.concatenate(v) for k, v in parts.items()}
    counts = {k: vis.histogram2d(v[:, :2], val=4 if k == "latent" else 6, num=256)
              for k, v in arrays.items()}
    drg = np.concatenate([vis.get_imshow_plot(counts[k])
                          for k in ("data", "recon", "gen")], axis=1)
    gt = vis.get_imshow_plot(
        vis.get_prob_from_energy_func_for_vis(normal_energy_func, num=256))
    lat = np.concatenate([gt, vis.get_imshow_plot(counts["latent"])], axis=1)
    writer.add_image("test/data-recon-gen/heatmap",
                     vis.convert_npimage_torchimage(drg), 0)
    writer.add_image("test/latent/heatmap", vis.convert_npimage_torchimage(lat), 0)
    np.savez_compressed(os.path.join(opt.path, "toy-dump.npz"),
                        data_recon_gen=drg, gt_latent=lat,
                        **{f"{k}_counts": v for k, v in counts.items()})
    bad = sum(int((~np.isfinite(arrays[k])).sum()) for k in ("recon", "gen", "latent"))
    logging("-" * 89, path=opt.path)
    logging(f"| toy dump   | sec {time.time() - t0:5.2f} | rows "
            f"{len(arrays['data'])} | non-finite {bad} ", path=opt.path)
    logging("-" * 89, path=opt.path)
    return arrays


class EndIterError(Exception):
    """Final-mode stop (reference utils/msc.py:112-113)."""
