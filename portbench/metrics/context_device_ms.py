"""Phase A's hidden1a context (``train/step.py`` ``cdae_update``, the port's
``ardae.context`` span: an aux model's std-0 pass over the trunk and both
heads for the 450-wide feature h): device ms a step of the operations
launched inside the span. None where the port records no such span (the
lt0 lines, whose context is a reshape, and a port without it)."""

import dataclasses

SPAN = "ardae.context"


def read(run):
    try:
        from ardae_tpu_torch.utils.tracing import recorded
    except ImportError:  # a port without spans
        return None
    lo, hi = run.trace.window
    ivs = sorted((r.t0_ns * 1e-9, r.t1_ns * 1e-9) for r in recorded()
                 if r.name == SPAN and lo <= r.t0_ns * 1e-9 <= hi)
    s = dataclasses.replace(run.trace, spans={SPAN: ivs}).device_s(SPAN) if ivs else 0.0
    return s * 1e3 / run.trace.steps if s else None
