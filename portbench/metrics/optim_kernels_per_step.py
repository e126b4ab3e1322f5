"""Optimizers (``train/optim.py`` ``TorchAdam``, ``TorchRMSprop``): device
kernels launched inside torch's own ``Optimizer.step#...`` spans, a
step."""

from portbench.tracing import OPTIMIZER


def read(run):
    n = run.trace.count(OPTIMIZER)
    return n / run.trace.steps if n else None
