"""Phase A's sampling pass (``train/step.py`` ``cdae_update``, the port's
``ardae.sample`` span: the sigma statistics over the encoder's samples,
the context and the DSM noise draws): device ms a step of the operations
launched inside the span. None where the port records no spans."""

import dataclasses

SPAN = "ardae.sample"


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
