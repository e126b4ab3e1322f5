"""Swiss-roll AR-DAE score matching (JAX twin: examples/ardae_toy.py;
reference notebooks/ardae_toy.ipynb).

Same as dae_toy but sigma-conditioned: sigma ~ delta * N(0, 1) per row, the
DAE receives sigma as an input, and the learned field can be queried at any
noise level (sigma = 0: the data score).

Run: python -m ardae_tpu_torch.examples.ardae_toy [--score-type grad|res]
     [--iterations N] [--out-prefix PREFIX] [--no-cuda]
"""

import argparse

import torch

from ardae_tpu_torch.cli.common import select_device
from ardae_tpu_torch.examples.dae_toy import (
    build_dae,
    dsm_step,
    is_log_step,
    score_field,
    swissroll_sampler,
)
from ardae_tpu_torch.models.cdae import MLPGradARDAE, MLPResARDAE
from ardae_tpu_torch.train.optim import torch_adam
from ardae_tpu_torch.utils.visualization import get_quiver_plot, save_png


def train(score_type="grad", iterations=5000, batch_size=256, num_sigma=10,
          hidden_dim=128, lr=0.005, delta=1.0, log_interval=500, seed=0,
          log=print, device="cuda"):
    """Returns (dae, the loss at each log step)."""
    dev = select_device(torch.device(device).type == "cpu")
    dae = build_dae(MLPGradARDAE if score_type == "grad" else MLPResARDAE,
                    hidden_dim, seed, dev)
    opt = torch_adam(dae.parameters(), lr, b1=0.9)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = batch_size * num_sigma
    losses = []
    for i in range(iterations):
        x = swissroll_sampler(gen, batch_size)
        sigma = delta * torch.randn(n, 1, generator=gen, device=dev)
        loss = dsm_step(dae, opt, x, sigma, num_sigma, gen)
        if is_log_step(i, log_interval, iterations):
            losses.append(float(loss))
            log(f"| {i + 1:5d}/{iterations} | delta {delta:5.3f} "
                f"| loss (dae) {losses[-1]:5.3f}")
    return dae, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--score-type", default="grad", choices=["grad", "res"])
    ap.add_argument("--iterations", type=int, default=5000)
    ap.add_argument("--out-prefix", default="ardae_toy_quiver")
    ap.add_argument("--no-cuda", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    dae, _ = train(score_type=args.score_type, iterations=args.iterations,
                   device="cpu" if args.no_cuda else "cuda")
    # the notebook plots the field at sigma=0 and sigma=delta (cell 8)
    for sigma in (0.0, 1.0):
        grad, xs, ys = score_field(dae, sigma=sigma)
        out = f"{args.out_prefix}_s{sigma}.png"
        save_png(out, get_quiver_plot(grad, xs, ys, xlim=5, ylim=5))
        print(f"score field at sigma={sigma} saved to {out}")


if __name__ == "__main__":
    main()
