"""TrainState: the model, its optimizer, the step count, for the implicit
VAEs the cdae and its optimizer, and under weight averaging the averaged
model and its count (JAX twin: ardae_tpu/train/state.py). The baseline VAE
has no cdae: both are None, and ``state_dict`` leaves them out, as it
leaves out the averaging slots of a run without averaging. The port
updates parameters in place."""

import copy
import dataclasses
from typing import Optional

import torch

_OPTIONAL = ("cdae", "opt_cdae", "avg_model")


def avg_copy(model):
    """An independent copy of ``model`` on its device, without gradients:
    the averaging slot's start (JAX: ``jax.tree.map(jnp.array, params)``)."""
    avg = copy.deepcopy(model).requires_grad_(False)
    for p in avg.parameters():
        p.grad = None
    return avg


@dataclasses.dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    opt_model: torch.optim.Optimizer
    cdae: Optional[torch.nn.Module] = None
    opt_cdae: Optional[torch.optim.Optimizer] = None
    # Polyak / SWA (train/step.py update_weight_avg): the averaged model and
    # the steps averaged since the start; None without averaging
    avg_model: Optional[torch.nn.Module] = None
    avg_count: Optional[int] = None

    @property
    def eval_model(self):
        """What evaluation, visualization and the toy dump read (JAX: the
        drivers' ``eval_params``): the averaged model where the state has
        one, else the live model."""
        return self.model if self.avg_model is None else self.avg_model

    def state_dict(self):
        """Tensors and Python scalars only, so ``torch.load(...,
        weights_only=True)`` reads it back."""
        sd = {"step": int(self.step),
              "model": self.model.state_dict(),
              "opt_model": self.opt_model.state_dict()}
        for name in _OPTIONAL:
            if getattr(self, name) is not None:
                sd[name] = getattr(self, name).state_dict()
        if self.avg_model is not None:
            sd["avg_count"] = int(self.avg_count)
        return sd

    def load_state_dict(self, sd):
        """In place; each tensor is copied to its live counterpart's device."""
        self.step = int(sd["step"])
        self.model.load_state_dict(sd["model"])
        self.opt_model.load_state_dict(sd["opt_model"])
        for name in _OPTIONAL:
            if getattr(self, name) is not None:
                getattr(self, name).load_state_dict(sd[name])
        if self.avg_model is not None:
            self.avg_count = int(sd["avg_count"])


def create_train_state(model, opt_model, cdae=None, opt_cdae=None,
                       weight_avg="none"):
    averaging = weight_avg != "none"
    return TrainState(0, model, opt_model, cdae, opt_cdae,
                      avg_copy(model) if averaging else None,
                      0 if averaging else None)
