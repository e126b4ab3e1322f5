"""Step loop (``train/step.py`` ``train_chunk``, the port's ``ardae.upload``
span: the step's indices copied from host arrays to the card, each copy
waiting for the stream to drain): host ms a step inside the span. Long
when the device is behind the host at the step's start. None where the
port records no spans."""


def read(run):
    try:
        from ardae_tpu_torch.utils.tracing import recorded
    except ImportError:  # a port without spans
        return None
    lo, hi = run.trace.window
    ns = [r.t1_ns - r.t0_ns for r in recorded()
          if r.name == "ardae.upload" and lo <= r.t0_ns * 1e-9 <= hi]
    return sum(ns) * 1e-6 / run.trace.steps if ns else None
