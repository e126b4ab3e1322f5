"""Device: the share of the traced stretch in which no device operation
ran, in %."""


def read(run):
    lo, hi = run.trace.window
    busy = run.trace.busy_s()
    return 100.0 * (1.0 - busy / (hi - lo)) if busy else None
