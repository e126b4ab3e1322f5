"""Whole step: the joint step's FLOP, counted from the configuration's
shapes (``yardstick.step_flop``), over the untraced window's ``step_ms``
at the fp32-accurate rate of 165 TFLOP/s (495 / 3), in %."""

from portbench import yardstick


def read(run):
    return 100.0 * yardstick.step_flop(run.config) / (run.step_ms * 1e-3 * yardstick.FP32_PEAK)
