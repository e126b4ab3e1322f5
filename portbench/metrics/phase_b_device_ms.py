"""Phase B (``train/step.py`` ``model_update``: the VAE's loss and
gradients with the cdae's score injected, and the model's optimizer):
device ms a step of the operations launched inside the benchmark's span
around ``model_update``."""

from portbench.tracing import PHASES


def read(run):
    s = run.trace.device_s(PHASES["model_update"])
    return s * 1e3 / run.trace.steps if s else None
