"""TrainState: both networks, their optimizers and the step count
(JAX twin: ardae_tpu/train/state.py). The port updates parameters in place;
weight averaging waits (ROADMAP queue 1, slice 6)."""

import dataclasses

import torch


@dataclasses.dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    opt_model: torch.optim.Optimizer
    cdae: torch.nn.Module
    opt_cdae: torch.optim.Optimizer

    def state_dict(self):
        """Tensors and Python scalars only, so ``torch.load(...,
        weights_only=True)`` reads it back."""
        return {"step": int(self.step),
                "model": self.model.state_dict(),
                "opt_model": self.opt_model.state_dict(),
                "cdae": self.cdae.state_dict(),
                "opt_cdae": self.opt_cdae.state_dict()}

    def load_state_dict(self, sd):
        """In place; each tensor is copied to its live counterpart's device."""
        self.step = int(sd["step"])
        self.model.load_state_dict(sd["model"])
        self.opt_model.load_state_dict(sd["opt_model"])
        self.cdae.load_state_dict(sd["cdae"])
        self.opt_cdae.load_state_dict(sd["opt_cdae"])


def create_train_state(model, opt_model, cdae, opt_cdae):
    return TrainState(0, model, opt_model, cdae, opt_cdae)
