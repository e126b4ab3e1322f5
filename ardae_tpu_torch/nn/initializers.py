"""Initializers matching the reference's (PyTorch-1.2) parameter statistics.

The torch-1.2 default of ``nn.Linear`` and ``nn.Conv2d`` is
kaiming_uniform(a=sqrt(5)), which equals U(+-1/sqrt(fan_in)) for the weight,
and U(+-1/sqrt(fan_in)) for the bias. The reference's ``weight_init``
(models/ivae/mnist.py:20-25) is xavier-uniform weights and zero biases.
Several heads draw their weight from N(0, 1) instead (the JAX twin's
``normal_init(1.0)``, e.g. models/ivae/toy.py:91). Every draw takes an
explicit ``torch.Generator``; nothing reads the global RNG.
"""

import math

import torch


def uniform_(t: torch.Tensor, bound: float, generator: torch.Generator):
    """In-place U(-bound, bound) from ``generator`` (drawn on the generator's
    device, then copied, so a CPU generator seeds a CUDA module the same)."""
    with torch.no_grad():
        u = torch.rand(t.shape, generator=generator, dtype=t.dtype,
                       device=generator.device)
        t.copy_(u.mul_(2.0 * bound).sub_(bound))
    return t


def normal_(t: torch.Tensor, generator: torch.Generator):
    """In-place N(0, 1) from ``generator`` (drawn on its device, then
    copied)."""
    with torch.no_grad():
        n = torch.randn(t.shape, generator=generator, dtype=t.dtype,
                        device=generator.device)
        t.copy_(n)
    return t


def torch_default_(weight: torch.Tensor, bias, fan_in: int,
                   generator: torch.Generator):
    """torch-1.2 default init of a linear or conv layer."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    uniform_(weight, bound, generator)
    if bias is not None:
        uniform_(bias, bound, generator)


def xavier_(weight: torch.Tensor, bias, fan_in: int, fan_out: int,
             generator: torch.Generator):
    """Xavier-uniform weight, U(+-sqrt(6 / (fan_in + fan_out))), zero bias."""
    uniform_(weight, math.sqrt(6.0 / (fan_in + fan_out)), generator)
    if bias is not None:
        with torch.no_grad():
            bias.zero_()


def init_module(module: torch.nn.Module, generator: torch.Generator):
    """Re-draw every parameter of ``module`` from ``generator``, in module
    registration order (each leaf layer implements ``init_params(gen)``)."""
    for m in module.modules():
        if hasattr(m, "init_params"):
            m.init_params(generator)
    return module
