"""Step loop (``train/step.py`` ``train_chunk`` / ``one_step``, the
loader's ``gather_batches``): device kernels launched in the traced
stretch, a step. Moves ``step_ms`` through the launch overhead each kernel
costs the host."""


def read(run):
    n = run.trace.count()
    return n / run.trace.steps if n else None
