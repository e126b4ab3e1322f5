"""DSM kernels (``csrc/fused_dsm.cu``, ``csrc/fused_dsm_grad.cu`` over
``csrc/dsm_sgemm.cuh``, or the plain score net in a plain cell): the DSM
loss's least time, forward and backward (``yardstick.dsm_bound_ms``), over
the device time of the operations launched inside the port's ``ardae.dsm``
span (the loss and its backward alone), in %. None where the port records
no spans."""

import dataclasses

from portbench import yardstick

SPAN = "ardae.dsm"


def read(run):
    try:
        from ardae_tpu_torch.utils.tracing import recorded
    except ImportError:  # a port without spans
        return None
    lo, hi = run.trace.window
    ivs = sorted((r.t0_ns * 1e-9, r.t1_ns * 1e-9) for r in recorded()
                 if r.name == SPAN and lo <= r.t0_ns * 1e-9 <= hi)
    s = dataclasses.replace(run.trace, spans={SPAN: ivs}).device_s(SPAN) if ivs else 0.0
    if not s:
        return None
    b = yardstick.dsm_bound_ms(run.config)
    least_ms = (b["fwd"] + b["bwd"]) * run.config["num_cdae_updates"] * run.trace.steps
    return 100.0 * least_ms / (s * 1e3)
