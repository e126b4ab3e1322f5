"""Gradient-injection surrogate (JAX twin: ardae_tpu/core/aux_grad.py;
reference models/aux.py:9-37).

The reference's autograd.Function returns 0 and emits a stored gradient in
its backward; here, as in the JAX twin, it is one differentiable
expression, sum(g.detach() * x): its value is sum(g * x) (never read), its
gradient with respect to x is g exactly and g receives none. The joint
step (train/step.py ``model_update``) writes the same term inline.
"""

import torch


def aux_loss_for_grad(x, grad):
    """A scalar whose d/dx equals ``grad`` exactly; ``grad`` gets no gradient."""
    return torch.sum(grad.detach() * x)
