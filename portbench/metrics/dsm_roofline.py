"""DSM kernels (``csrc/fused_dsm.cu``, ``csrc/fused_dsm_grad.cu`` over
``csrc/dsm_sgemm.cuh``): the least time of the DSM loss's forward and
backward (the yardstick's bound: 3xTF32 products at 495 TFLOP/s, or bytes
at 3.35 TB/s), over the device time of phase A less its optimizer, in %.
The same work is counted whatever computes it, so a plain cell reports it
too; the context and sampling kernels of phase A are in the time until
the port has a span around the loss alone."""

from portbench import yardstick
from portbench.tracing import OPTIMIZER, PHASES


def read(run):
    device_s = run.trace.device_s(PHASES["cdae_update"], minus=OPTIMIZER)
    if not device_s:
        return None
    b = yardstick.dsm_bound_ms(run.config)
    least_ms = (b["fwd"] + b["bwd"]) * run.config["num_cdae_updates"] * run.trace.steps
    return 100.0 * least_ms / (device_s * 1e3)
