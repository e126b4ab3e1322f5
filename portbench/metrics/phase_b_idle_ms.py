"""Phase B (``train/step.py`` ``model_update``, the port's ``ardae.phase_b``
span): device idle ms a step in the gaps whose next operation was launched
inside the span, by ``tracing.breakdown``'s rule (a gap is the time from
the end of all earlier operations to an operation's start). Read with the
profiler's cost on the host, so a relative gauge, as ``device_idle_pct``
is. None where the port records no spans."""

import dataclasses

SPAN = "ardae.phase_b"


def read(run):
    try:
        from ardae_tpu_torch.utils.tracing import recorded
    except ImportError:  # a port without spans
        return None
    lo, hi = run.trace.window
    ivs = sorted((r.t0_ns * 1e-9, r.t1_ns * 1e-9) for r in recorded()
                 if r.name == SPAN and lo <= r.t0_ns * 1e-9 <= hi)
    if not ivs or not run.trace.ops:
        return None
    trace = dataclasses.replace(run.trace, spans={SPAN: ivs})
    idle, end = 0.0, lo
    for o in trace.ops:
        if o.start > end and o.launch is not None and trace.inside(o.launch, SPAN):
            idle += o.start - end
        end = max(end, o.start + o.dur)
    return idle * 1e3 / trace.steps
