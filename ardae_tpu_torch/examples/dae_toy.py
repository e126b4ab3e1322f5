"""Swiss-roll DAE score matching (JAX twin: examples/dae_toy.py; reference
notebooks/dae_toy.ipynb).

Trains an unconditional, fixed-sigma DAE on swiss-roll samples, sigma
annealed from sigma_max to sigma_min, and draws the learned score field as
a quiver panel. Each iteration is one eager step on the device (the JAX
twin runs a lax.scan a log interval).

Run: python -m ardae_tpu_torch.examples.dae_toy [--score-type grad|res]
     [--iterations N] [--out FILE] [--no-cuda]
"""

import argparse
import math

import numpy as np
import torch

from ardae_tpu_torch.cli.common import select_device
from ardae_tpu_torch.models.cdae import MLPGradDAE, MLPResDAE, dae_loss, dae_score
from ardae_tpu_torch.nn.initializers import init_module
from ardae_tpu_torch.train.optim import torch_adam
from ardae_tpu_torch.utils.visualization import get_quiver_plot, save_png


def swissroll_sampler(generator, n, noise=0.5):
    """make_swiss_roll(...)[:, [0, 2]] / 3 (notebook cell 2), drawn from
    ``generator`` on its device."""
    dev = generator.device
    t = 1.5 * math.pi * (1.0 + 2.0 * torch.rand(n, generator=generator, device=dev))
    pts = torch.stack([t * torch.cos(t), t * torch.sin(t)], dim=1)
    return (pts + noise * torch.randn(n, 2, generator=generator, device=dev)) / 3.0


def build_dae(ctor, hidden_dim, seed, device):
    """The examples' score net: 3 hidden softplus layers on 2-D points,
    drawn from ``seed``."""
    dae = ctor(input_dim=2, h_dim=hidden_dim, num_hidden_layers=3,
               nonlinearity="softplus")
    return init_module(dae, torch.Generator().manual_seed(seed)).to(device)


def dsm_step(dae, opt, x, sigma, num_sigma, generator=None, eps=None):
    """One DSM update of ``dae`` on the points ``x`` (bs, 2), each repeated
    ``num_sigma`` times, at noise level ``sigma`` (scalar or (bs *
    num_sigma, 1)); ``eps`` injected or drawn from ``generator``. Returns
    the loss."""
    bs, d = x.shape
    xr = x[:, None, :].expand(bs, num_sigma, d).reshape(bs * num_sigma, d)
    loss = dae_loss(dae, xr, sigma, generator=generator, eps=eps)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach()


def is_log_step(i, log_interval, iterations):
    """The JAX twin logs at the end of each lax.scan chunk."""
    return (i + 1) % log_interval == 0 or i + 1 == iterations


def train(score_type="grad", iterations=5000, batch_size=256, num_sigma=10,
          hidden_dim=128, lr=0.005, sigma_max=5.0, sigma_min=0.05,
          sigma_annealing=4000, log_interval=500, seed=0, log=print,
          device="cuda"):
    """Returns (dae, the loss at each log step); the module holds its
    parameters (the JAX twin returns them beside it)."""
    dev = select_device(torch.device(device).type == "cpu")
    dae = build_dae(MLPGradDAE if score_type == "grad" else MLPResDAE,
                    hidden_dim, seed, dev)
    opt = torch_adam(dae.parameters(), lr, b1=0.9)
    gen = torch.Generator(device=dev).manual_seed(seed)
    losses = []
    for i in range(iterations):
        perc = min((i + 1) / float(sigma_annealing), 1.0)
        sigma = sigma_max * (1 - perc) + sigma_min * perc
        loss = dsm_step(dae, opt, swissroll_sampler(gen, batch_size), sigma,
                        num_sigma, gen)
        if is_log_step(i, log_interval, iterations):
            losses.append(float(loss))
            log(f"| {i + 1:5d}/{iterations} | sigma {sigma:5.3f} "
                f"| loss (dae) {losses[-1]:5.3f}")
    return dae, losses


def score_field(dae, val=5.0, nbins=41, sigma=0.0):
    """The score at an nbins x nbins grid over [-val, val]^2: (grad (nbins^2,
    2), xs, ys) as numpy."""
    lin = np.linspace(-val, val, nbins)
    xs, ys = np.meshgrid(lin, lin)
    pts = torch.as_tensor(np.stack([xs.ravel(), ys.ravel()], 1), dtype=torch.float32,
                          device=next(dae.parameters()).device)
    with torch.no_grad():
        grad = dae_score(dae, pts, sigma).cpu().numpy()
    return grad, xs, ys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--score-type", default="grad", choices=["grad", "res"])
    ap.add_argument("--iterations", type=int, default=5000)
    ap.add_argument("--out", default="dae_toy_quiver.png")
    ap.add_argument("--no-cuda", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    dae, _ = train(score_type=args.score_type, iterations=args.iterations,
                   device="cpu" if args.no_cuda else "cuda")
    grad, xs, ys = score_field(dae)
    save_png(args.out, get_quiver_plot(grad, xs, ys, xlim=5, ylim=5))
    print(f"score-field quiver saved to {args.out}")


if __name__ == "__main__":
    main()
