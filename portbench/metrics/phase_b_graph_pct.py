"""Phase B (``train/step.py`` ``model_update``, the port's ``ardae.phase_b``
span): the share of the traced stretch's phase-B spans that replayed the
captured CUDA graph (hold an ``ardae.phase_b.replay`` span), in %. None
where the port has no phase-B graph (``PhaseBGraph``) or records no
spans."""

SPAN, REPLAY = "ardae.phase_b", "ardae.phase_b.replay"


def read(run):
    try:
        from ardae_tpu_torch.train.step import PhaseBGraph  # noqa: F401
        from ardae_tpu_torch.utils.tracing import recorded
    except ImportError:  # a port without spans or without the graph
        return None
    lo, hi = run.trace.window
    mine = [r for r in recorded() if lo <= r.t0_ns * 1e-9 <= hi]
    outer = [(r.t0_ns, r.t1_ns) for r in mine if r.name == SPAN]
    inner = [(r.t0_ns, r.t1_ns) for r in mine if r.name == REPLAY]
    if not outer:
        return None
    held = sum(any(a <= c and d <= b for c, d in inner) for a, b in outer)
    return 100.0 * held / len(outer)
