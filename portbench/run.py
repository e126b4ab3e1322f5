"""One run of one cell of the port's benchmark, on the card it starts on.

    python -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (timed from the process's start): imports, the CUDA context, phase
A's kernel library (built only where its sources changed), the inputs and
weights made on the card from the seed, the three checked steps through
the window's own call, and a fixed warm-up. The window then runs whole
chunks of the log interval through ``train_chunk`` until ``--seconds``
have passed, and ends on a synchronize. ``--trace 1`` adds a traced
stretch after the window and reports the per-layer metrics instead of the
end-to-end ones. After the program's state is freed, the plain reference
follows the checked steps and the comparison decides ``correct``.

The process keeps to the first CORES cores it may use (``pin_cores``), so
that every run has the same cores.

Lines before the last: the set-up's parts, the card, the host's cores,
their clocks and the time stolen from them, the window, and the numbers
compared (also the last lines of standard error). The last line of
standard output is the result, one JSON object. Without a card, or with
fewer cards than the cell asks for, it exits 2 and prints no result.
"""

import os
import sys
import time


def _process_age():
    """Seconds since this process started (Linux), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, AttributeError):
        return 0.0


AGE = _process_age()
T_TOP = time.perf_counter()
T0 = T_TOP - AGE
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORES = 4


def use_checkout_caches():
    """Every build and compile cache inside the checkout, at fixed paths:
    the kernel caches, and Python's bytecode. Where site-packages holds no
    bytecode and the environment forbids writing it, every process
    compiles torch and torch._dynamo from source (~16 s on the card's
    host); under ``build/pycache`` only a checkout's first run does."""
    for var, d in (("CUDA_CACHE_PATH", "build/cuda-cache"), ("TRITON_CACHE_DIR", "build/triton"),
                   ("TORCH_EXTENSIONS_DIR", "build/torch-extensions")):
        os.environ[var] = os.path.join(ROOT, d)
    os.environ["USE_FLAX"] = "0"
    sys.pycache_prefix = os.path.join(ROOT, "build", "pycache")
    sys.dont_write_bytecode = False


def pin_cores(n=CORES):
    """Keep this process, and every thread it starts, on the first ``n``
    cores it may use. Returns the cores."""
    cores = sorted(os.sched_getaffinity(0))[:n]
    os.sched_setaffinity(0, cores)
    return cores


def cpu_mhz(cores):
    """The current clock of each of ``cores`` in MHz: cpufreq's, else
    /proc/cpuinfo's, else None."""
    try:
        with open("/proc/cpuinfo") as f:
            listed = [float(ln.split(":")[1]) for ln in f if ln.startswith("cpu MHz")]
    except (OSError, ValueError):
        listed = []
    out = []
    for c in cores:
        try:
            with open(f"/sys/devices/system/cpu/cpu{c}/cpufreq/scaling_cur_freq") as f:
                out.append(int(f.read()) / 1000.0)
        except (OSError, ValueError):
            out.append(listed[c] if c < len(listed) else None)
    return out


def cpu_steal_s(cores):
    """Seconds that the hypervisor ran something else on ``cores`` while
    they had work (``steal`` in /proc/stat), summed, or None."""
    try:
        with open("/proc/stat") as f:
            lines = {ln.split()[0]: ln.split() for ln in f if ln.startswith("cpu")}
        return sum(int(lines[f"cpu{c}"][8]) for c in cores) / os.sysconf("SC_CLK_TCK")
    except (OSError, KeyError, IndexError, ValueError):
        return None


if __name__ == "__main__":
    use_checkout_caches()
    pin_cores()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import traceback  # noqa: E402
from contextlib import nullcontext  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "ardae_tpu")
CHECKED_STEPS = 3


def parse_args(argv):
    p = argparse.ArgumentParser(prog="python -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line():
    """nvidia-smi's name, clocks and power limit of the card, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.max.sm,clocks.mem,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "nvidia-smi not available"


def shapes(config):
    from portbench import reference as R

    return dict(updates=config["num_cdae_updates"], bs=config["train_batch_size"],
                pixels=config["nchannels"] * config["nheight"] ** 2,
                nz=config["train_nz_cdae"], nstd=config["train_nstd_cdae"],
                nz_model=config["train_nz_model"], noise=R.noise_widths(config),
                z=config["model_z_dim"])


class Run:
    """What the per-layer readers read: the cell, the window and the trace."""

    def __init__(self, cell, steps, window_s, trace):
        self.config, self.traffic = cell.config, cell.traffic
        self.steps, self.window_s, self.trace = steps, window_s, trace
        self.step_ms = window_s * 1e3 / steps


def bench(args, require_cuda=True, root=None, out=print):
    """The run; returns the result dict. ``require_cuda=False`` (tests)
    runs wherever torch puts its tensors, the CPU here."""
    from portbench import manifest

    cell = manifest.cell(args.workload, root)
    t = time.perf_counter()
    parts = {"interpreter_s": AGE, "harness_s": t - T_TOP}
    import numpy  # noqa: F401
    import torch

    parts["import_torch_s"] = time.perf_counter() - t
    if require_cuda and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < cell.chips):
        raise SystemExit(2)
    t = time.perf_counter()
    import ardae_tpu_torch.cli.ivae_ardae  # noqa: F401
    import ardae_tpu_torch.ops.fused_dsm  # noqa: F401
    import ardae_tpu_torch.ops.fused_dsm_grad  # noqa: F401
    from ardae_tpu_torch.cli.common import select_device
    from ardae_tpu_torch.models import registry  # noqa: F401
    from ardae_tpu_torch.train import optim, state, step  # noqa: F401

    from portbench import checks
    from portbench import program as prog
    from portbench import reference as R
    from portbench.reference import step as S

    parts["import_port_s"] = time.perf_counter() - t
    # torch.optim imports much of torch lazily at the first optimizer built:
    # a part of its own, not the weights'
    t = time.perf_counter()
    optim.TorchAdam([torch.nn.Parameter(torch.zeros(1))], lr=0.0)
    parts["first_optimizer_s"] = time.perf_counter() - t
    t = time.perf_counter()
    if require_cuda:
        device = select_device(False)
        torch.cuda.init()
        torch.empty(1, device=device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    else:
        device = torch.device("cpu")
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    parts["cuda_context_s"] = time.perf_counter() - t

    config, traffic = cell.config, cell.traffic
    if traffic["use_kernels"] and device.type == "cuda":
        lib = prog.load_library(R.cdae(config).STYLE)
        parts[f"library_{lib['name']}_s"] = lib["s"]
        out(f"library {lib['name']}: built {str(lib['built']).lower()} "
            f"build_s {lib['build_s']:.3f}")

    program, data, feed, gen, w0, obs, ref_steps = checked_setup(cell, args.seed, device, parts)
    t = time.perf_counter()
    program.chunk(data, feed, gen, traffic["warmup_steps"])
    sync()
    parts["warmup_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - T0

    # the window
    cores = sorted(os.sched_getaffinity(0))
    mhz_before, steal_before = cpu_mhz(cores), cpu_steal_s(cores)
    marks = [time.perf_counter()]
    events = step_events(torch) if args.trace and device.type == "cuda" else nullcontext([])
    with events as step_times:
        steps, window_s, bad = prog.window(program, data, feed, gen, args.seconds,
                                           traffic["chunk_steps"],
                                           on_chunk=lambda n: marks.append(time.perf_counter()))
    mhz_after, steal_after = cpu_mhz(cores), cpu_steal_s(cores)
    step_p95 = _p95_ms(torch, step_times)
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    run = Run(cell, steps, window_s, None)

    result_metrics, trace_info, result_breakdown = {}, {}, None
    if args.trace:
        from portbench import tracing

        trace = tracing.traced_stretch(
            lambda k: program.chunk(data, feed, gen, k), traffic["trace_steps"], device)
        run.trace = trace
        for m in cell.per_layer:
            v = manifest.reader(m["name"], cell.root)(run)
            if v is not None:
                result_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        busy = trace.busy_s()
        trace_info = {"busy_s": busy, "window_s": trace.window[1] - trace.window[0]}
        result_breakdown = tracing.breakdown(trace)
        out(f"traced {trace.steps} steps: {trace.wall_s * 1e3 / trace.steps:.3f} ms/step "
            f"against {run.step_ms:.3f} untraced (profiler overhead "
            f"{100 * (trace.wall_s * 1e3 / trace.steps / run.step_ms - 1):.1f} %); "
            f"device ops {len(trace.ops)}, unmatched launches "
            f"{sum(o.launch is None for o in trace.ops)}")
        if step_p95 is not None:
            out(f"step p95 from stream events {step_p95:.3f} ms over {len(step_times) - 1} steps")
    else:
        e2e = {"step_ms": run.step_ms, "setup_s": setup_s}
        for m in cell.end_to_end:
            result_metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    # the program's state goes; the reference follows the checked steps
    del program
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = S.run_steps(config, w0["model"], w0["cdae"], data, ref_steps)
    values = checks.numbers(obs, ref)
    ok, rows = checks.judge(values, cell.limits) if cell.limits else (False, [
        (n, values[n], None) for n in checks.NAMES])
    reference_s = time.perf_counter() - t

    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules loaded that the port may not load: {', '.join(found)}")
    for k, v in parts.items():
        out(f"setup {k} {v:.3f}")
    out(f"setup setup_s {setup_s:.3f}")
    out(f"window {steps} steps in {window_s:.3f} s ({run.step_ms:.3f} ms/step); "
        f"reference {reference_s:.3f} s")
    out("chunks ms/step " + " ".join(f"{(b - a) * 1e3 / traffic['chunk_steps']:.2f}"
                                     for a, b in zip(marks, marks[1:])))
    if device.type == "cuda":
        out(f"card {card_line()}")
    out(f"host cores {','.join(map(str, cores))} of {os.cpu_count()}; MHz before the window "
        f"{' '.join(map(str, mhz_before))}, after {' '.join(map(str, mhz_after))}; stolen in the "
        f"window {None if steal_after is None else round(steal_after - steal_before, 2)} s")
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak), **trace_info}
    result = {"correct": bool(ok and bad == 0), "attempted": steps, "failed": bad,
              "metrics": result_metrics, "device": device_info}
    if result_breakdown is not None:
        result["breakdown"] = result_breakdown
    result["checks"] = {n: {"value": v if v == v else None, "limit": lim} for n, v, lim in rows}
    return result


def checked_setup(cell, seed, device, parts):
    """Inputs, weights and the port's state from ``seed``, driven through
    the checked steps: the window's own call and feed, with the draws
    injected so that the reference can follow. Times each part into
    ``parts``. Returns (program, data, feed, generator, weights, what the
    program produced, the steps for the reference)."""
    import torch

    from portbench import inputs
    from portbench import program as prog
    from portbench import reference as R
    from portbench.reference import layers

    config, traffic = cell.config, cell.traffic
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    t = time.perf_counter()
    data = inputs.images(seed, config["train_rows"], shapes(config)["pixels"], device)
    feed = inputs.IndexFeed(seed, config["train_rows"], config["train_batch_size"], device)
    draws = inputs.step_draws(seed, CHECKED_STEPS, shapes(config), device)
    gen = inputs.generator(seed, "program", device)
    sync()
    parts["inputs_s"] = time.perf_counter() - t

    t = time.perf_counter()
    specs = R.specs(config)
    w0 = inputs.weights(seed, specs, {k: layers.init_bounds(v) for k, v in specs.items()}, device)
    program = prog.Program(config, traffic, device, seed)
    program.load_weights(w0)
    sync()
    parts["weights_s"] = time.perf_counter() - t

    # the checked steps: the window's own call and feed, with the draws
    # injected so that the reference can follow
    t = time.perf_counter()
    obs, ref_steps = {"losses": []}, []
    for i in range(CHECKED_STEPS):
        m, c_idx, m_idx = program.chunk(data, feed, gen, 1, draws=[draws[i]])
        obs["losses"].append((m["cdae_loss"], m["model_loss"]))
        if i == 0:
            obs["first_grad"] = program.first_grads()
        ref_steps.append({"c_idx": torch.as_tensor(c_idx[0], device=device),
                          "m_idx": torch.as_tensor(m_idx[0], device=device),
                          "bin_cdae": draws[i]["bin_cdae"], "bin_model": draws[i]["bin_model"],
                          **draws[i]["step"]})
    obs["delta"] = program.delta(w0)
    sync()
    parts["checked_steps_s"] = time.perf_counter() - t

    return program, data, feed, gen, w0, obs, ref_steps


@contextlib.contextmanager
def step_events(torch):
    """Record a CUDA event on the stream after each joint step (no
    synchronize), by wrapping ``one_step``; yields the list they go to."""
    from ardae_tpu_torch.train import step

    events, one_step = [], step.one_step

    def timed(*a, **k):
        out = one_step(*a, **k)
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        events.append(e)
        return out

    step.one_step = timed
    try:
        yield events
    finally:
        step.one_step = one_step


def _p95_ms(torch, events):
    if len(events) < 21:
        return None
    import statistics

    torch.cuda.synchronize()
    gaps = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return statistics.quantiles(gaps, n=20)[-1]


def main(argv=None):
    args = parse_args(sys.argv[1:] if argv is None else argv)
    try:
        result = bench(args)
    except SystemExit as e:
        if e.code == 2:
            print("error: no CUDA device, or fewer than the cell asks for: no result",
                  file=sys.stderr)
        return int(e.code or 1)
    except Exception as e:  # the run's boundary: one error line, no result
        tb = traceback.extract_tb(e.__traceback__)[-1]
        print(f"error: {type(e).__name__}: {e} (at {os.path.basename(tb.filename)}:{tb.lineno})",
              file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
