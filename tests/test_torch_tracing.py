"""The port's spans (ardae_tpu_torch/utils/tracing.py) in a tiny joint
step on the CPU: nothing recorded and no range entered without a profiler;
under one, the spans of the table in ``train/step.py`` with their parents,
steps and counts, on the profiler's clock, phase A split into the sampling
pass, the DSM loss and the optimizer, inside the benchmark's own phase
spans; and the benchmark's readers of the spans on a trace built by hand."""

import contextlib
import dataclasses
import statistics
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ardae_tpu_torch.cli.ivae_ardae import build_parser, build_state
from ardae_tpu_torch.train.step import StepConfig, train_chunk
from ardae_tpu_torch.utils import tracing
from portbench import manifest, yardstick
from portbench import tracing as bench_tracing
from portbench.tracing import Op, Trace

torch.set_num_threads(2)

U, STEPS, BSZ, ROWS = 2, 2, 16, 128
FLAGS = (
    "--dataset 25gaussians --nheight 1 --nchannels 2 "
    "--model mlp-concat --model-z-dim 2 --model-h-dim 16 --model-n-layers 2 "
    "--model-nonlin relu --model-n-dim 4 "
    "--cdae mlp-grad --cdae-h-dim 16 --cdae-n-layers 2 --cdae-nonlin softplus "
    "--cdae-ctx-type lt0 --train-batch-size 16 --train-nz-cdae 4 "
    "--m-optimizer adam --d-optimizer rmsprop --no-cuda"
).split()
PARENT = {"ardae.step": None, "ardae.upload": "ardae.step", "ardae.gather": "ardae.step",
          "ardae.phase_a": "ardae.step", "ardae.sample": "ardae.phase_a",
          "ardae.dsm": "ardae.phase_a", "ardae.phase_b": "ardae.step",
          "ardae.sample.latents": "ardae.sample"}
PER_STEP = {"ardae.step": 1, "ardae.upload": 1, "ardae.gather": 1, "ardae.phase_a": U,
            "ardae.sample": U, "ardae.dsm": U, "ardae.phase_b": 1, "ardae.sample.latents": U}


def _chunk():
    """A closure running the tiny joint chunk: STEPS steps of U updates."""
    state, _ = build_state(build_parser().parse_args(FLAGS), torch.device("cpu"))
    cfg = StepConfig(std_scale=100.0, delta=0.1, num_cdae_updates=U, train_nz_cdae=4,
                     ctx_type="lt0")
    data = torch.rand(ROWS, 2, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    c_idx = rng.integers(0, ROWS, (STEPS, U, BSZ))
    m_idx = rng.integers(0, ROWS, (STEPS, BSZ))
    gen = torch.Generator().manual_seed(1)
    return lambda: train_chunk(state, cfg, data, c_idx, m_idx, gen, lambda s: 1.0)


def _traced(wrap=None):
    """The chunk under the profiler (inside ``wrap``); returns (the
    records, the profiler's CPU events as (name, start_ns, end_ns))."""
    run = _chunk()
    tracing.clear()
    with wrap or contextlib.nullcontext(), profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CPU]
    return tracing.recorded(), events


def _within(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_profiler_switch_flips():
    """The switch ``span`` reads is torch's, set inside torch.profiler.profile."""
    from torch.autograd import profiler

    assert profiler._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiler._is_profiler_enabled is True
    assert profiler._is_profiler_enabled is False


def test_off_is_one_shared_noop(monkeypatch):
    """Without a profiler every span is the same object, no
    record_function is entered, and a chunk records nothing."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert tracing.span("a") is tracing.span("b", step=3)
    run = _chunk()
    tracing.clear()
    run()
    assert tracing.recorded() == []


def test_spans_of_a_chunk():
    """Names, parents, steps and counts per step as the table in
    train/step.py has them; each child inside its parent."""
    records, _ = _traced()
    assert {r.name for r in records} == set(PARENT)
    for step in range(STEPS):
        mine = [r for r in records if r.step == step]
        counts = {n: sum(r.name == n for r in mine) for n in PARENT}
        assert counts == PER_STEP, step
        for r in mine:
            assert r.parent == PARENT[r.name], r
            assert r.t0_ns <= r.t1_ns
            if r.parent:
                assert any(_within((r.t0_ns, r.t1_ns), (p.t0_ns, p.t1_ns))
                           for p in mine if p.name == r.parent), r


def test_records_on_the_profilers_clock():
    """The records share the profiler's clock: at each end, the median
    distance from a record to its own record_function event is under 50
    us. (One record can read more: the thread may be preempted between
    its stamp and the range's.) Another clock would be off by far more."""
    records, events = _traced()
    starts, ends = [], []
    for name in PARENT:
        mine = sorted((r.t0_ns, r.t1_ns) for r in records if r.name == name)
        theirs = sorted((a, b) for n, a, b in events if n == name)
        assert len(mine) == len(theirs) == STEPS * PER_STEP[name]
        for (a, b), (c, d) in zip(mine, theirs):
            starts.append(abs(a - c))
            ends.append(abs(b - d))
    assert statistics.median(starts) < 50_000 and statistics.median(ends) < 50_000, (
        sorted(starts), sorted(ends))


def test_phase_a_partitioned():
    """Every aten op inside phase A lies in the sampling pass, the DSM loss
    or torch's optimizer step span."""
    records, events = _traced()
    ivs = lambda name: [(r.t0_ns, r.t1_ns) for r in records if r.name == name]
    parts = ivs("ardae.sample") + ivs("ardae.dsm") + [
        (a, b) for n, a, b in events if n.startswith("Optimizer.step#")]
    inside_a = [(n, a, b) for n, a, b in events if n.startswith("aten::")
                and any(_within((a, b), iv) for iv in ivs("ardae.phase_a"))]
    assert inside_a
    outside = [n for n, a, b in inside_a if not any(_within((a, b), p) for p in parts)]
    assert outside == []


def test_benchmark_phase_spans_wrap_the_ports():
    """Under the benchmark's own phase spans, each portbench.phase_a holds
    one ardae.phase_a and each portbench.phase_b one ardae.phase_b."""
    records, events = _traced(bench_tracing.phase_spans())
    for bench, port in (("portbench.phase_a", "ardae.phase_a"),
                        ("portbench.phase_b", "ardae.phase_b")):
        outer = [(a, b) for n, a, b in events if n == bench]
        inner = [(r.t0_ns, r.t1_ns) for r in records if r.name == port]
        assert len(outer) == len(inner) > 0
        assert all(any(_within(i, o) for o in outer) for i in inner)


def test_other_thread_takes_the_main_threads_parent():
    """A span opened on another thread with none of its own open (autograd's
    device thread in a CUDA backward) takes the main thread's innermost
    span as its parent, and its step."""
    def worker():
        with tracing.span("worker"):
            pass

    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("outer", step=7), tracing.span("inner"):
            t = threading.Thread(target=worker)
            t.start()
            t.join()
    got = {r.name: (r.parent, r.step) for r in tracing.recorded()}
    assert got == {"outer": (None, 7), "inner": ("outer", 7), "worker": ("inner", 7)}


# the readers of the spans (portbench/metrics/), on a trace built by hand:
# a 1-s window from t = 100 s, two steps, ops at known launches
W0 = 100.0
S = 1_000_000_000  # ns a second


def _rec(name, t0, t1):
    return tracing.Record(name, int(round(t0 * S)), int(round(t1 * S)), None, 0)


def _run():
    ops = [Op("k0", W0 + 0.010, 0.005, W0 + 0.001, True),    # sample
           Op("k1", W0 + 0.020, 0.004, W0 + 0.002, True),    # sample
           Op("k2", W0 + 0.030, 0.010, W0 + 0.012, True),    # dsm
           Op("k3", W0 + 0.100, 0.002, W0 + 0.090, True),    # phase B, gap 0.060
           Op("k4", W0 + 0.103, 0.001, W0 + 0.095, True),    # phase B, gap 0.001
           Op("k5", W0 + 0.200, 0.003, W0 + 0.150, True),    # outside, gap 0.096
           Op("k6", W0 + 0.300, 0.020, W0 + 0.251, True),    # dsm
           Op("k7", W0 + 0.400, 0.001, W0 + 0.380, True),    # phase B, gap 0.080
           Op("k8", W0 + 0.500, 0.001, None, False)]         # unmatched
    trace = Trace(2, (W0, W0 + 1.0), ops, {}, [], 1.0)
    config = manifest.cell("flagship-fp32-kernels").config
    return type("Run", (), {"trace": trace, "config": config})()


RECORDS = [_rec("ardae.sample", W0 + 0.000, W0 + 0.005),
           _rec("ardae.dsm", W0 + 0.010, W0 + 0.015),
           _rec("ardae.phase_b", W0 + 0.080, W0 + 0.100),
           _rec("ardae.dsm", W0 + 0.250, W0 + 0.260),
           _rec("ardae.phase_b", W0 + 0.370, W0 + 0.390),
           _rec("ardae.phase_b.replay", W0 + 0.085, W0 + 0.095),  # in the first
           _rec("ardae.upload", W0 + 0.0000, W0 + 0.0004),
           _rec("ardae.upload", W0 + 0.2400, W0 + 0.2410),
           # before the window: left out
           _rec("ardae.sample", W0 - 0.5, W0 - 0.4),
           _rec("ardae.upload", W0 - 0.5, W0 - 0.3)]


def _expected(config):
    b = yardstick.dsm_bound_ms(config)
    dsm_ms = (b["fwd"] + b["bwd"]) * config["num_cdae_updates"] * 2
    return {"sampling_device_ms": (0.005 + 0.004) * 1e3 / 2,
            "dsm_loss_roofline": 100.0 * dsm_ms / ((0.010 + 0.020) * 1e3),
            "phase_b_idle_ms": (0.060 + 0.001 + 0.080) * 1e3 / 2,
            "upload_wait_ms": (0.0004 + 0.0010) * 1e3 / 2,
            "phase_b_graph_pct": 50.0}


@pytest.mark.parametrize("metric", ["sampling_device_ms", "dsm_loss_roofline",
                                    "phase_b_idle_ms", "upload_wait_ms",
                                    "phase_b_graph_pct"])
def test_reader_by_hand(monkeypatch, metric):
    run = _run()
    monkeypatch.setattr(tracing, "recorded", lambda: list(RECORDS))
    got = manifest.reader(metric)(run)
    assert got == pytest.approx(_expected(run.config)[metric], rel=1e-9)
    monkeypatch.setattr(tracing, "recorded", lambda: [])
    assert manifest.reader(metric)(run) is None
    # a port without the tracing module: None, no raise
    monkeypatch.setitem(sys.modules, "ardae_tpu_torch.utils.tracing", None)
    assert manifest.reader(metric)(run) is None


def test_readers_leave_the_trace_alone(monkeypatch):
    """The readers add no span to the trace the other readers read."""
    run = _run()
    before = dataclasses.replace(run.trace)
    monkeypatch.setattr(tracing, "recorded", lambda: list(RECORDS))
    for metric in ("sampling_device_ms", "dsm_loss_roofline", "phase_b_idle_ms",
                   "phase_b_graph_pct"):
        manifest.reader(metric)(run)
    assert run.trace.spans == before.spans == {}


def test_graph_share_without_the_graph(monkeypatch):
    """A port without a phase-B graph (the parent of its reader): None."""
    from ardae_tpu_torch.train import step

    monkeypatch.setattr(tracing, "recorded", lambda: list(RECORDS))
    monkeypatch.delattr(step, "PhaseBGraph")
    assert manifest.reader("phase_b_graph_pct")(_run()) is None
