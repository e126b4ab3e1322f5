"""Named spans of the port's layers, on the profiler's clock.

``with span("ardae.phase_a"):`` costs one check while no profiler records
and returns a shared no-op. Inside ``torch.profiler.profile`` it enters a
``record_function`` range of that name, so the Chrome trace of
``--profile-dir`` shows it, and keeps a ``Record`` in a bounded buffer:
the name, its start and end on ``time.time_ns()`` (the clock Kineto
stamps its events on, so a device operation's launch can be put down to
the span it ran in), the enclosing span's name and the joint step the
span belongs to. ``recorded()`` returns the records, ``clear()`` drops
them.

``count("ardae.sample.latents.rows", n)`` keeps a ``Count`` beside them
while a profiler records (the name, the number, when on the same clock,
and the step of the innermost open span) and otherwise costs the same
one check; ``counted()`` returns them.

The enclosing span is the innermost one open on the same thread. The
autograd engine runs a CUDA backward on a thread of its own while the
caller waits in ``backward()``; a span opened there with none of its own
open takes the main thread's innermost one.
"""

import collections
import contextlib
import threading
import time

import torch
import torch.autograd.profiler as _profiler

Record = collections.namedtuple("Record", "name t0_ns t1_ns parent step")
Count = collections.namedtuple("Count", "name n t_ns step")

_records = collections.deque(maxlen=1 << 16)
_counts = collections.deque(maxlen=1 << 16)
_stacks = {}  # thread ident -> the spans open on it, innermost last

_OFF = contextlib.nullcontext()  # what ``span`` returns while no profiler records


def _open(stack):
    """The spans open on this thread, else on the main thread, else [None]."""
    return stack or _stacks.get(threading.main_thread().ident) or [None]


class _Span:
    __slots__ = ("name", "step", "parent", "stack", "rf", "t0")

    def __init__(self, name, step):
        self.name, self.step = name, step

    def __enter__(self):
        self.stack = _stacks.setdefault(threading.get_ident(), [])
        outer = _open(self.stack)
        self.parent = outer[-1] and outer[-1].name
        if self.step is None and outer[-1] is not None:
            self.step = outer[-1].step
        self.stack.append(self)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        self.rf.__exit__(*exc)
        self.stack.pop()
        _records.append(Record(self.name, self.t0, t1, self.parent, self.step))
        return False


def span(name, step=None):
    """A context manager around one of the port's layers; ``step`` names
    the joint step (the outermost span's; inner spans inherit it)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, step)


def count(name, n):
    """Count ``n`` of ``name`` (rows, items) in the innermost open span's
    step; nothing while no profiler records."""
    if not _profiler._is_profiler_enabled:
        return
    inner = _open(_stacks.get(threading.get_ident()))[-1]
    _counts.append(Count(name, int(n), time.time_ns(), inner and inner.step))


def recorded():
    """The records kept, in the order their spans ended."""
    return list(_records)


def counted():
    """The counts kept, in the order they were made."""
    return list(_counts)


def clear():
    _records.clear()
    _counts.clear()
