"""TrainState: the model, its optimizer, the step count, and for the implicit
VAEs the cdae and its optimizer (JAX twin: ardae_tpu/train/state.py). The
baseline VAE has no cdae: both are None, and ``state_dict`` leaves them out.
The port updates parameters in place; weight averaging waits (ROADMAP queue
1, slice 6)."""

import dataclasses
from typing import Optional

import torch

_OPTIONAL = ("cdae", "opt_cdae")


@dataclasses.dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    opt_model: torch.optim.Optimizer
    cdae: Optional[torch.nn.Module] = None
    opt_cdae: Optional[torch.optim.Optimizer] = None

    def state_dict(self):
        """Tensors and Python scalars only, so ``torch.load(...,
        weights_only=True)`` reads it back."""
        sd = {"step": int(self.step),
              "model": self.model.state_dict(),
              "opt_model": self.opt_model.state_dict()}
        for name in _OPTIONAL:
            if getattr(self, name) is not None:
                sd[name] = getattr(self, name).state_dict()
        return sd

    def load_state_dict(self, sd):
        """In place; each tensor is copied to its live counterpart's device."""
        self.step = int(sd["step"])
        self.model.load_state_dict(sd["model"])
        self.opt_model.load_state_dict(sd["opt_model"])
        for name in _OPTIONAL:
            if getattr(self, name) is not None:
                getattr(self, name).load_state_dict(sd[name])


def create_train_state(model, opt_model, cdae=None, opt_cdae=None):
    return TrainState(0, model, opt_model, cdae, opt_cdae)
