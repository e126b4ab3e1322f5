"""The training step of the baseline (Gaussian-posterior) VAEs (JAX twin:
ardae_tpu/train/vae_step.py and the chunk body of ardae_tpu/cli/vae.py).

One optimizer; the loss is scaled by ``loss_scale`` (1/(C*H*W) in the
driver, reference vae.py:410-411) before the backward, and the scaled loss
is the one reported. beta comes from the driver's annealing schedule.
PyTorch runs eagerly: the K-step chunk is a Python loop with the batch
gather and the Bernoulli binarization on the device. After each step the
averaged model moves as in the joint step (train/step.py
``update_weight_avg``; JAX cli/vae.py:248-250). ``compute_dtype``
"bfloat16" runs the loss in the JAX driver's mixed precision
(cli/vae.py:234-239; models/vae/api.py ``vae_loss``).
"""

import dataclasses

import torch

from ardae_tpu_torch.data.loader import gather_batches
from ardae_tpu_torch.models.vae.api import vae_loss
from ardae_tpu_torch.train.step import update_weight_avg


@dataclasses.dataclass(frozen=True)
class VAEStepConfig:
    loss_scale: float = 1.0
    compute_dtype: str = "float32"  # float32 | bfloat16
    weight_avg: str = "none"  # none | polyak | swa
    weight_avg_start: int = 1000
    weight_avg_decay: float = 0.998


def vae_step(state, cfg, batch, beta, generator, eps=None):
    """One update of ``state`` in place on a (B, D) batch; an aux model's
    loss is ``aux_vae_loss`` (through ``vae_loss``), its KLD the two terms'
    sum. ``eps``: the injected posterior draw (B, z_dim), or an aux model's
    pair (eps0, eps). Returns the metrics (detached)."""
    loss, terms = vae_loss(state.model, batch, beta=beta, generator=generator,
                           eps=eps, compute_dtype=cfg.compute_dtype)
    loss = cfg.loss_scale * loss
    state.opt_model.zero_grad(set_to_none=True)
    loss.backward()
    state.opt_model.step()
    state.step += 1
    update_weight_avg(state, cfg)
    recon, kld = terms["recon"].detach(), terms["kld"].detach()
    return {"loss": loss.detach(), "recon_loss": recon, "kld_loss": kld,
            "elbo": -(recon + kld)}


def train_vae_chunk(state, cfg, data, idx, generator, beta_fn, binarize=False,
                    draws=None):
    """K steps over (K, B) integer indices into ``data`` (N, D) on the
    device. ``draws``: optional per-step list of {"bin": (B, D) uniforms,
    "eps": (B, z_dim) or an aux model's pair}. Returns the last step's
    metrics."""
    metrics = None
    for k in range(len(idx)):
        d = draws[k] if draws else {}
        batch = gather_batches(data, torch.as_tensor(idx[k], device=data.device),
                               binarize, generator, d.get("bin"))
        metrics = vae_step(state, cfg, batch, beta_fn(state.step), generator,
                           d.get("eps"))
    return metrics
