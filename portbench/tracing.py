"""The traced stretch: a few steps of the window's own call under
``torch.profiler``, reduced to what the per-layer readers read.

Spans come from the benchmark, not from the program: for the traced run
only, the module attributes ``cdae_update`` and ``model_update`` of
``ardae_tpu_torch.train.step`` are wrapped in ``record_function`` (phase A
and phase B; ``one_step`` looks them up at each call), and torch names its
own ``Optimizer.step#<class>.step`` spans. A device operation belongs to a
span when the host call that launched it (matched by CUPTI's correlation
id) ran inside the span.
"""

import bisect
import contextlib
import dataclasses
import time

import torch

PHASES = {"cdae_update": "portbench.phase_a", "model_update": "portbench.phase_b"}
WINDOW = "portbench.traced_window"
OPTIMIZER = "Optimizer.step#"


@dataclasses.dataclass
class Op:
    """A device operation: kernel, copy or set."""
    name: str
    start: float   # seconds, the profiler's clock
    dur: float
    launch: float  # when its host call ran; None when unmatched
    kernel: bool


@dataclasses.dataclass
class Trace:
    """What the readers read from one traced stretch."""
    steps: int
    window: tuple            # (start, end) of the traced window, seconds
    ops: list                # [Op], by start
    spans: dict              # name -> [(start, end)], host spans
    host_ops: list           # [(start, end, name)] of the innermost aten ops
    wall_s: float            # host clock around the traced chunk

    def inside(self, launch, name):
        """Whether a launch at ``launch`` ran inside a span ``name`` (a
        prefix for the optimizer's)."""
        for key, ivs in self.spans.items():
            if key == name or (name.endswith("#") and key.startswith(name)):
                i = bisect.bisect_right(ivs, (launch, float("inf"))) - 1
                if i >= 0 and ivs[i][0] <= launch <= ivs[i][1]:
                    return True
        return False

    def device_s(self, name, minus=None):
        """Device seconds of the ops launched inside span ``name``, less
        those inside ``minus`` as well."""
        return sum(o.dur for o in self.ops if o.launch is not None
                   and self.inside(o.launch, name)
                   and not (minus and self.inside(o.launch, minus)))

    def count(self, name=None):
        return sum(1 for o in self.ops if o.kernel and (
            name is None or (o.launch is not None and self.inside(o.launch, name))))

    def busy_s(self):
        """Seconds of the window in which some device operation ran."""
        lo, hi = self.window
        busy, end = 0.0, lo
        for o in self.ops:
            s, e = max(o.start, end), min(o.start + o.dur, hi)
            if e > s:
                busy += e - s
                end = e
        return busy

    def host_at(self, t):
        """The spans, outermost first, and the innermost aten op the host
        was in at ``t``."""
        inside = sorted((a, k) for k, ivs in self.spans.items() if k != WINDOW
                        for a, b in ivs if a <= t <= b)
        span = " / ".join(k for _, k in inside)
        i = bisect.bisect_right(self.host_ops, (t, float("inf"), "")) - 1
        op = None
        for a, b, n in reversed(self.host_ops[max(0, i - 200): i + 1]):
            if a <= t <= b:
                op = n
                break
        return " / ".join(x for x in (span, op) if x) or "host"


def _ns(e, which):
    f = getattr(e, f"{which}_ns", None)
    return f() if f is not None else getattr(e, f"{which}_us")() * 1000


def parse(events, steps, wall_s):
    """A Trace from the profiler's kineto events."""
    launches, ops, spans, aten = {}, [], {}, []
    # a record_function range shows on the device's timeline too, under its
    # host name: it is no device operation
    host_names = {e.name() for e in events if e.device_type() == torch.autograd.DeviceType.CPU}
    for e in events:
        name, start = e.name(), _ns(e, "start") * 1e-9
        dur = e.duration_ns() * 1e-9 if hasattr(e, "duration_ns") else e.duration_us() * 1e-6
        if e.device_type() != torch.autograd.DeviceType.CPU:
            annotation = getattr(e, "is_user_annotation", lambda: False)()
            if not annotation and name not in host_names:
                ops.append((name, start, dur, e.correlation_id()))
        elif name.startswith("cu") and e.correlation_id():
            launches[e.correlation_id()] = start
        elif name.startswith("portbench.") or name.startswith(OPTIMIZER):
            spans.setdefault(name, []).append((start, start + dur))
        elif name.startswith("aten::"):
            aten.append((start, start + dur, name))
    window = spans.get(WINDOW, [(0.0, float("inf"))])[0]
    out = []
    for name, start, dur, corr in sorted(ops, key=lambda o: o[1]):
        if window[0] <= start <= window[1]:
            kernel = not name.startswith(("Memcpy", "Memset", "memcpy", "memset"))
            out.append(Op(name, start, dur, launches.get(corr), kernel))
    for ivs in spans.values():
        ivs.sort()
    aten.sort()
    return Trace(steps, window, out, spans, aten, wall_s)


@contextlib.contextmanager
def phase_spans():
    """Wrap phase A and phase B of the port's step in spans, and restore."""
    from ardae_tpu_torch.train import step

    saved = {k: getattr(step, k) for k in PHASES}

    def wrap(fn, label):
        def inner(*args, **kwargs):
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)
        return inner

    for k, label in PHASES.items():
        setattr(step, k, wrap(saved[k], label))
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(step, k, fn)


def traced_stretch(run_chunk, steps, device):
    """``run_chunk(steps)`` under the profiler with the phase spans;
    returns the Trace."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    with phase_spans(), profile(activities=acts) as prof:
        sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function(WINDOW):
            run_chunk(steps)
            sync()
        wall = time.perf_counter() - t0
    return parse(prof.profiler.kineto_results.events(), steps, wall)


def breakdown(trace, top=10):
    """{"device_ops": the device operations that took most time, "idle_gaps":
    the idle time between operations, by what the host was doing when the
    operation after the gap was launched}."""
    by_op, gaps = {}, {}
    end = trace.window[0]
    for o in trace.ops:
        by_op[o.name] = by_op.get(o.name, 0.0) + o.dur
        if o.start > end and o.launch is not None:
            key = trace.host_at(o.launch)
            gaps[key] = gaps.get(key, 0.0) + (o.start - end)
        end = max(end, o.start + o.dur)
    rank = lambda d: [[k[:64], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(by_op), "idle_gaps": rank(gaps)}
