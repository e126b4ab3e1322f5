"""Phase A (``train/step.py`` ``cdae_update``: the sigma statistics, the
context, the DSM loss through a fused kernel or the plain score net, and
the cdae's optimizer): device ms a step of the operations launched inside
the benchmark's span around ``cdae_update``."""

from portbench.tracing import PHASES


def read(run):
    s = run.trace.device_s(PHASES["cdae_update"])
    return s * 1e3 / run.trace.steps if s else None
