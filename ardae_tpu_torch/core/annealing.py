"""Annealing schedule (JAX twin: ardae_tpu/core/annealing.py;
reference utils/msc.py:53-55)."""


def annealing_func(val_init, val_fin, val_annealing, step):
    """Linear ramp from val_init to val_fin over val_annealing steps; the
    final value at once when ``val_annealing`` is None."""
    if val_annealing is None:
        return val_fin
    frac = min(float(val_annealing), step) / float(val_annealing)
    return val_init + (val_fin - val_init) * frac
