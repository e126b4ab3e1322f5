"""The 25-gaussians gate of the port: mode coverage and test IWS-64 of a
trained mlp-concat model.

    python scripts/torch_toy_gate.py --exp EXPERIMENT_DIR [--data-root DIR]

Loads the model from EXPERIMENT_DIR's ``checkpoint`` (the line's widths of
scripts/run_vae_25gaussians.sh by default), draws ``--samples`` points from
its generator (z ~ N(0, I), decoded and sampled) and reports, as one JSON
line beside the card's name and power limit:
  * ``modes``: the modes covered. A sample belongs to its nearest mode when
    it lies within 3 sigma of it (sigma = sqrt(0.1)); a mode is covered when
    at least 1 % of the samples belong to it;
  * ``within_3sigma``: the share of samples that belong to a mode;
  * ``weight_min`` / ``weight_max``: the least and largest share of the
    samples a mode holds;
  * ``gt_logpdf``: the mean ground-truth log-density of the samples
    (``real_logpdf``: that of the test split, the data's own);
  * ``test_iws``: the IWS-64 bound over the whole test split (20,000
    points), from the generator seeded from (``--seed``, 999,983).
A training run writes ``checkpoint`` every ``--ckpt-interval`` steps only, so
the model scored is the last one saved (``iter`` in the JSON line), which
can precede the run's last step and the final dump's model.
Runs on the card unless ``--no-cuda`` is given; torch and the port only.
"""

import argparse
import json
import math
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ardae_tpu_torch.cli.common import (  # noqa: E402
    TEST_EVAL_TAG,
    eval_generator,
    evaluate_iws_ivae,
    select_device,
)
from ardae_tpu_torch.data import get_dataset  # noqa: E402
from ardae_tpu_torch.data.toy import mixture_modes, toy_logpdf  # noqa: E402
from ardae_tpu_torch.models.ivae.api import generate  # noqa: E402
from ardae_tpu_torch.models.registry import build_ivae_model  # noqa: E402


def coverage(samples, name="25gaussians"):
    """(modes covered, share within 3 sigma, per-mode shares (N,))."""
    mu, std = mixture_modes(name)
    d = np.linalg.norm(samples[:, None, :] - mu[None], axis=-1)
    nearest = np.argmin(d, axis=1)
    near = d[np.arange(len(samples)), nearest] <= 3.0 * std
    shares = np.bincount(nearest[near], minlength=len(mu)) / len(samples)
    return int((shares >= 0.01).sum()), float(near.mean()), shares


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--exp", required=True)
    p.add_argument("--checkpoint", default="checkpoint")
    p.add_argument("--data-root", default="data")
    p.add_argument("--samples", type=int, default=20_000)
    p.add_argument("--iws-samples", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--model-z-dim", type=int, default=2)
    p.add_argument("--model-h-dim", type=int, default=256)
    p.add_argument("--model-n-dim", type=int, default=10)
    p.add_argument("--model-n-layers", type=int, default=2)
    p.add_argument("--model-nonlin", default="relu")
    p.add_argument("--no-cuda", action="store_true")
    opt = p.parse_args(argv)

    device = select_device(opt.no_cuda)
    model = build_ivae_model(
        "mlp-concat", nchannels=2, nheight=1, z_dim=opt.model_z_dim,
        h_dim=opt.model_h_dim, n_dim=opt.model_n_dim,
        n_layers=opt.model_n_layers, nonlin=opt.model_nonlin, device=device)
    payload = torch.load(os.path.join(opt.exp, opt.checkpoint),
                         map_location=device, weights_only=True)
    model.load_state_dict(payload["state"]["model"])
    model.eval()

    gen = eval_generator(opt.seed, 0, device)
    with torch.no_grad():
        samples = generate(model, opt.samples, generator=gen)[0].cpu().numpy()
    modes, within, shares = coverage(samples)
    splits = get_dataset("25gaussians", root=opt.data_root)
    logpdf = toy_logpdf("25gaussians")
    test_iws = evaluate_iws_ivae(model, splits["test"], opt.iws_samples,
                                 eval_generator(opt.seed, TEST_EVAL_TAG, device))
    card = "cpu"
    if device.type == "cuda":
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        card = out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    result = {
        "iter": int(payload["meta"]["i_ep"]), "samples": opt.samples,
        "modes": modes, "within_3sigma": within,
        "weight_min": float(shares.min()), "weight_max": float(shares.max()),
        "gt_logpdf": float(np.mean(logpdf(samples))),
        "real_logpdf": float(np.mean(logpdf(splits["test"]))),
        "test_iws": test_iws, "finite": bool(np.isfinite(samples).all()
                                             and math.isfinite(test_iws)),
        "device": card}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
