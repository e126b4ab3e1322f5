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


def create_train_state(model, opt_model, cdae, opt_cdae):
    return TrainState(0, model, opt_model, cdae, opt_cdae)
