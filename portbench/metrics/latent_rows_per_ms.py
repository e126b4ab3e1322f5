"""Phase A's nz-row sampling pass (``train/step.py`` ``_sigma_stats``, the
port's ``ardae.sample.latents`` span: the encoder over bs x nz noise rows):
the rows the port counts there (``ardae.sample.latents.rows``, from the
shape of the latents the pass returned) over the device ms of the
operations launched inside the span, in rows/ms. A pass that returns
fewer rows counts fewer, so it cannot read as faster. None where the port
records no such span or counter."""

import dataclasses

SPAN = "ardae.sample.latents"
ROWS = "ardae.sample.latents.rows"


def read(run):
    try:
        from ardae_tpu_torch.utils.tracing import counted, recorded
    except ImportError:  # a port without the span's counter
        return None
    lo, hi = run.trace.window
    ivs = sorted((r.t0_ns * 1e-9, r.t1_ns * 1e-9) for r in recorded()
                 if r.name == SPAN and lo <= r.t0_ns * 1e-9 <= hi)
    rows = sum(c.n for c in counted() if c.name == ROWS and lo <= c.t_ns * 1e-9 <= hi)
    s = dataclasses.replace(run.trace, spans={SPAN: ivs}).device_s(SPAN) if ivs else 0.0
    return rows / (s * 1e3) if s and rows else None
