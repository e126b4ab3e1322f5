"""Entry points of the port (twin of __graft_entry__.py): a forward check
of the flagship conv IVAE, and the multi-device dry run.

``entry()``: (fn, example_args), the IVAE loss of the mnist-conv model on a
small batch (JAX ``entry``, the forward step).

``dryrun_multichip(n)``: one FULL joint training step (both phases, both
optimizers) over a data-parallel mesh of n ranks at tiny shapes, then over
a (data, sample) mesh of (n/2, 2) when n >= 4 is even, in one world of n
ranks (parallel/launch.py); every metric must be finite. The ranks run on
``devices``, by default a card each (NCCL); CPU processes (gloo) when the
caller passes ["cpu"] * n, several ranks on one card (gloo) when it passes
that card n times.

    python -m ardae_tpu_torch.graft_entry [N] [--no-cuda]
"""

import math
import sys

import torch

Z_DIM, NOISE_DIM, H_CDAE = 8, 16, 32


def _batch(bsz):
    """A binary (bsz, 784) batch from seed 0, on the CPU."""
    return torch.rand((bsz, 784), generator=torch.Generator().manual_seed(0)).round()


def _build_flagship(device, bsz=4):
    """The JAX dry run's models and batch: mnist-conv (z 8, noise 16,
    softplus), an mlp-grad cdae (h 32, 2 layers, relu) on the data context,
    and ``_batch``."""
    from ardae_tpu_torch.models.registry import (
        build_cdae,
        build_ivae_model,
        context_dim_for,
    )

    model = build_ivae_model("mnist-conv", nchannels=1, nheight=28, z_dim=Z_DIM,
                             n_dim=NOISE_DIM, nonlin="softplus", device=device)
    ctx_dim = context_dim_for("data", model_name="mnist-conv", nchannels=1,
                              nheight=28, z_dim=Z_DIM, h_dim=0)
    cdae = build_cdae("mlp-grad", input_dim=Z_DIM, context_dim=ctx_dim,
                      h_dim=H_CDAE, n_layers=2, nonlin="relu", device=device)
    return model, cdae, _batch(bsz).to(device)


def entry(device="cuda"):
    """(fn, example_args): fn(model, batch, generator) -> (loss, (recon,
    prior)), the IVAE loss at nz 4 and beta 1."""
    from ardae_tpu_torch.models.ivae import api as ivae_api

    model, _, x = _build_flagship(device)

    def forward_step(model, batch, generator):
        loss, terms = ivae_api.ivae_loss(model, batch, 4, beta=1.0,
                                         generator=generator)
        return loss, (terms["recon"], terms["prior"])

    return forward_step, (model, x, torch.Generator(device=device).manual_seed(0))


def _dryrun_spec(n):
    import numpy as np

    bsz = 2 * n
    return {
        "model": ("mnist-conv", dict(nchannels=1, nheight=28, z_dim=Z_DIM,
                                     n_dim=NOISE_DIM, nonlin="softplus")),
        "cdae": ("mlp-grad", dict(input_dim=Z_DIM, context_dim=784, h_dim=H_CDAE,
                                  n_layers=2, nonlin="relu", seed=1)),
        "opt_model": ("adam", 1e-4, dict(beta1=0.5)),
        "opt_cdae": ("rmsprop", 1e-4, dict(momentum=0.5)),
        "cfg": dict(std_scale=100.0, delta=0.1, num_cdae_updates=1,
                    train_nz_cdae=4, train_nz_model=2, ctx_type="data"),
        "beta": 1.0, "data": _batch(bsz),
        "cdae_idx": np.arange(bsz).reshape(1, 1, bsz),
        "model_idx": np.arange(bsz).reshape(1, bsz)}


def _dryrun_rank(device, n):
    """One rank of the dry run: the joint step on each mesh, its metrics."""
    from ardae_tpu_torch.parallel.mesh import make_mesh, sample_parallel_mesh
    from ardae_tpu_torch.parallel.workers import run_joint

    spec = _dryrun_spec(n)
    meshes = [make_mesh(n, device)]
    if n >= 4 and n % 2 == 0:
        meshes.append(sample_parallel_mesh(n // 2, 2, device))
    return [run_joint(device, spec, mesh)["metrics"][0] for mesh in meshes]


def dryrun_multichip(n_devices, devices=None):
    """The dry run over ``n_devices`` ranks (module docstring); prints the
    JAX dry run's lines and returns rank 0's metrics of each mesh."""
    from ardae_tpu_torch.cli.common import mesh_devices
    from ardae_tpu_torch.parallel.launch import launch

    devices = devices or mesh_devices(
        False, n_devices, "mesh needs {n} devices but only {m} are available")
    if len(devices) != n_devices:
        raise ValueError(f"{len(devices)} devices for {n_devices} ranks")
    metrics = launch(_dryrun_rank, devices, n_devices)[0]
    for m, (dp, sp) in zip(metrics, [(n_devices, 1), (n_devices // 2, 2)]):
        bad = [k for k, v in m.items() if not math.isfinite(v)]
        if bad:
            raise RuntimeError(f"{bad} not finite under the (dp={dp}, sp={sp}) mesh")
    print(f"dryrun_multichip({n_devices}): ok — "
          + ", ".join(f"{k}={v:.4f}" for k, v in sorted(metrics[0].items())))
    if len(metrics) > 1:
        print(f"dryrun_multichip({n_devices}): (data, sample)=(dp={n_devices // 2}, "
              "sp=2) sharded joint step ok")
    return metrics


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--no-cuda"]
    on = "cpu" if "--no-cuda" in sys.argv else "cuda"
    fn, example = entry(on)
    with torch.no_grad():
        loss, (recon, prior) = fn(*example)
    print(f"entry forward loss: {float(loss):.4f} (recon {float(recon):.4f}, "
          f"prior {float(prior):.4f})")
    n = int(args[0]) if args else 8
    dryrun_multichip(n, ["cpu"] * n if on == "cpu" else None)
