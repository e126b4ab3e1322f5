"""Energy fitting with an implicit sampler and the AR-DAE entropy gradient
(JAX twin: examples/ardae_fit.py; reference notebooks/ardae_fit.ipynb).

An implicit generator g(z), z ~ N(0, I), is trained to match the density
exp(-energy_func4): its loss is alpha * E[energy(x)] minus the entropy,
whose gradient comes from a res-ARDAE trained by denoising score matching
on generator samples. Each iteration: num_dae_updates DSM steps (RMSprop,
momentum 0.5), then one generator step on alpha * E[energy] +
sum(stopgrad(score(x, 0)) * x) / bs (Adam b1 0.5 under StepLR(5000, 0.5)),
alpha annealed from 0.01 to 1 (notebook cells 6-10). The DSM loss of the
log line is computed at log steps only, between the two phases, from a
generator of its own, so the training draws do not depend on the log
cadence.

Run: python -m ardae_tpu_torch.examples.ardae_fit [--iterations N]
     [--out FILE] [--no-cuda]
"""

import argparse

import numpy as np
import torch
import torch.nn as nn

from ardae_tpu_torch.cli.common import select_device
from ardae_tpu_torch.core.annealing import annealing_func
from ardae_tpu_torch.core.energy import energy_func4
from ardae_tpu_torch.examples.dae_toy import build_dae, dsm_step, is_log_step
from ardae_tpu_torch.models.cdae import MLPResARDAE, dae_loss, dae_score
from ardae_tpu_torch.nn.initializers import init_module
from ardae_tpu_torch.nn.mlp import MLP
from ardae_tpu_torch.train.optim import step_lr, torch_adam, torch_rmsprop
from ardae_tpu_torch.utils.visualization import get_2d_histogram_plot, save_png

LOG_SEED = 777   # the log's DSM loss generator: seed + LOG_SEED


class Generator(nn.Module):
    """z -> x sampler MLP (notebook cell 4): 3 hidden relu layers."""

    def __init__(self, z_dim=10, hidden_dim=256):
        super().__init__()
        self.main = MLP(z_dim, hidden_dim, 2, nonlinearity="relu",
                        num_hidden_layers=3)

    def forward(self, z):
        return self.main(z)


def _randn(shape, generator, injected=None):
    if injected is not None:
        return injected.to(device=generator.device, dtype=torch.float32).reshape(shape)
    return torch.randn(shape, generator=generator, device=generator.device)


def _samples(gen, batch_size, z_dim, generator, z=None):
    with torch.no_grad():
        return gen(_randn((batch_size, z_dim), generator, z))


def dae_update(gen, dae, opt_d, batch_size, z_dim, num_sigma, delta, generator,
               draws=None):
    """Phase A, one DSM step of ``dae`` on fresh generator samples;
    ``draws``: optional injected (z (bs, z_dim), unit sigma (bs * num_sigma,
    1), eps (bs * num_sigma, 2)). Returns the loss."""
    z, s, e = draws or (None, None, None)
    x = _samples(gen, batch_size, z_dim, generator, z)
    sigma = delta * _randn((batch_size * num_sigma, 1), generator, s)
    return dsm_step(dae, opt_d, x, sigma, num_sigma, generator, eps=e)


def dsm_log_loss(gen, dae, batch_size, z_dim, num_sigma, delta, generator):
    """The DSM loss on fresh samples, for the log line only."""
    x = _samples(gen, batch_size, z_dim, generator)
    sigma = delta * _randn((batch_size * num_sigma, 1), generator)
    xr = x[:, None, :].expand(batch_size, num_sigma, 2).reshape(-1, 2)
    return dae_loss(dae, xr, sigma, generator=generator).detach()


def generator_update(gen, dae, opt_g, alpha, batch_size, z_dim, energy_func,
                     generator, z=None):
    """Phase B: one generator step on alpha * E[energy(x)] + sum(stopgrad(
    score(x, sigma 0)) * x) / bs, whose x-gradient is alpha * dE/dx minus
    the entropy gradient's estimate; ``z`` injected or drawn. Returns
    E[energy]."""
    x = gen(_randn((batch_size, z_dim), generator, z))
    model_loss = torch.mean(energy_func(x))
    with torch.no_grad():
        score = dae_score(dae, x.detach(), 0.0)
    loss = alpha * model_loss + torch.sum(score * x) / batch_size
    opt_g.zero_grad(set_to_none=True)
    loss.backward()
    opt_g.step()
    return model_loss.detach()


def train(iterations=50000, batch_size=1024, num_dae_updates=2, num_sigma=10,
          z_dim=10, hidden_dim=256, lr=0.001, delta=0.1,
          alpha_annealing=20000, log_interval=5000, seed=0, log=print,
          energy=None, device="cuda"):
    """Returns (generator, dae, [(E[energy], DSM loss) at each log step])."""
    dev = select_device(torch.device(device).type == "cpu")
    energy_func = energy or energy_func4
    gen = init_module(Generator(z_dim, hidden_dim),
                      torch.Generator().manual_seed(seed)).to(dev)
    dae = build_dae(MLPResARDAE, hidden_dim, seed + 1, dev)
    opt_g = torch_adam(gen.parameters(), step_lr(lr, 5000, 0.5, min_lr=1e-10), b1=0.5)
    opt_d = torch_rmsprop(dae.parameters(), lr, momentum=0.5)
    rng = torch.Generator(device=dev).manual_seed(seed)
    log_rng = torch.Generator(device=dev).manual_seed(seed + LOG_SEED)
    losses = []
    for i in range(iterations):
        alpha = annealing_func(0.01, 1.0, alpha_annealing, i)
        for _ in range(num_dae_updates):
            dae_update(gen, dae, opt_d, batch_size, z_dim, num_sigma, delta, rng)
        if is_log_step(i, log_interval, iterations):
            dl = float(dsm_log_loss(gen, dae, batch_size, z_dim, num_sigma, delta,
                                    log_rng))
        ml = generator_update(gen, dae, opt_g, alpha, batch_size, z_dim,
                              energy_func, rng)
        if is_log_step(i, log_interval, iterations):
            losses.append((float(ml), dl))
            log(f"| {i + 1:5d}/{iterations} | delta {delta:5.3f} "
                f"| alpha {alpha:5.3f} | loss (model) {losses[-1][0]:5.3f} "
                f"| loss (dae) {losses[-1][1]:5.3f}")
    return gen, dae, losses


def sample(gen, n, z_dim=10, seed=1):
    """n generator samples as numpy (n, 2), in chunks of 65,536 rows."""
    dev = next(gen.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed)
    out = []
    with torch.no_grad():
        for i in range(0, n, 65536):
            m = min(65536, n - i)
            out.append(gen(torch.randn(m, z_dim, generator=g, device=dev)).cpu().numpy())
    return np.concatenate(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iterations", type=int, default=50000)
    ap.add_argument("--out", default="ardae_fit_hist.png")
    ap.add_argument("--no-cuda", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    gen, _, _ = train(iterations=args.iterations, device="cpu" if args.no_cuda else "cuda")
    xs = sample(gen, 1_000_000)
    save_png(args.out, get_2d_histogram_plot(xs, val=4, num=256))
    print(f"sample histogram saved to {args.out}")


if __name__ == "__main__":
    main()
