"""Measurements of the port's DSM kernels and lines on one NVIDIA GPU.

    python3 scripts/torch_dsm_measure.py ab --old DIR [--new DIR]
    python3 scripts/torch_dsm_measure.py time [--tree DIR]
    python3 scripts/torch_dsm_measure.py profile [--tree DIR] [--no-steps]
    python3 scripts/torch_dsm_measure.py core [--tree DIR]

``time`` imports ardae_tpu_torch from DIR (default: this checkout), builds
its kernels there, and prints one JSON line: the median of 7 CUDA-event
runs of each kernel's forward and backward at its line's shape (res style:
the flagship, n 128 x 625, d 32, h 512, 5 layers; grad style: the
implicit-conv line, h 256), and the steady ms/step (mean of the last 5 of
10 steps) of both lines driven through cli.ivae_ardae with --use-kernels.
``ab`` runs ``time`` in a fresh process per turn, in the order old, new,
new, old, and prints each turn's line and a table of the medians. Two trees
compared in one call share one card: the only fair comparison.
``profile`` traces with torch.profiler one forward + backward of each
kernel at its line's shape and one steady step of each line, and prints
the device time by kernel name and the device's busy share of the traced
span. ``core`` times the shared GEMM core alone (its probe entry point,
csrc/dsm_sgemm.cuh dsm_sgemm_probe) at the lines' h x h and weight-gradient
shapes, in both precisions, as TFLOP/s of fp32 products (3xTF32 issues
three TF32 products for each). Each line names the card and its power
limit. Every number needs a
CUDA device: without one this script exits 2.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINES = {"res": (128, 625, 32, 512, 5, "softplus", 3),
         "grad": (128, 625, 32, 256, 5, "softplus", 3)}
STEPS, STEADY = 10, 5


def import_port(tree):
    sys.path.insert(0, os.path.abspath(tree))
    sys.path.insert(1, ROOT)   # chip_smoke.py of this checkout
    import chip_smoke
    from ardae_tpu_torch.models.registry import build_cdae
    from ardae_tpu_torch.ops import fused_dsm as fd
    from ardae_tpu_torch.ops import fused_dsm_grad as fg
    from ardae_tpu_torch.ops import native
    return chip_smoke, build_cdae, fd, fg, native


def kernel_cases(torch, tree):
    cs, build_cdae, fd, fg, native = import_port(tree)
    native.build(["fused_dsm", "fused_dsm_grad"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    out = {}
    for kind, cdae, fn in (("res", "mlp-res", fd.FusedDSMFunction),
                           ("grad", "mlp-grad", fg.FusedDSMGradFunction)):
        bsz, ssz, d, h, layers, act, seed = LINES[kind]
        args = cs.dsm_case(fd.prepare_inputs, build_cdae, torch, dev, cdae, bsz,
                           ssz, d, h, layers, act, seed)
        out[kind] = (fn.apply, args)
    return cs, out


def run_line(cs, torch, line_args):
    """Steady ms/step of STEPS steps of a line with --use-kernels."""
    from ardae_tpu_torch.cli import ivae_ardae

    with tempfile.TemporaryDirectory() as tmp:
        argv = line_args + [
            "--use-kernels", "--max-iters", str(STEPS), "--log-interval",
            str(STEADY), "--eval-iws-interval", "0", "--ckpt-interval", "0",
            "--skip-final-test-eval", "--no-resume",
            "--cache", os.path.join(tmp, "exp"), "--data-root", os.path.join(tmp, "data")]
        _, path = ivae_ardae.run(argv)
        torch.cuda.synchronize()
        with open(os.path.join(path, "log.txt")) as f:
            ms = [float(m) for m in re.findall(r"ms/step\s+(\S+)", f.read())]
    return ms[-1]


def cmd_time(a):
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cs, cases = kernel_cases(torch, a.tree)
    res = {"tree": os.path.abspath(a.tree), "card": cs.card_line()}
    for kind, (fn, args) in cases.items():
        leaves = [args[5]] + list(args[6:])
        loss = fn(*args)
        res[f"{kind}_fwd_ms"] = cs.time_ms(torch, lambda: fn(*args))
        res[f"{kind}_bwd_ms"] = cs.time_ms(
            torch, lambda: cs.grads(torch, loss, leaves, retain_graph=True))
        del loss
    del cases
    torch.cuda.empty_cache()
    res["flagship_ms_step"] = run_line(cs, torch, cs.FLAGSHIP_ARGS)
    torch.cuda.empty_cache()
    res["implicit_conv_ms_step"] = run_line(cs, torch, cs.IMPLICIT_CONV_ARGS)
    print(json.dumps(res), flush=True)
    return 0


# The GEMM core's products at the lines' shapes: (what, K-contiguous, M, N,
# K); the weight gradients split K as the kernels do (wgrad_splits)
CORE_CASES = (("h x h product, flagship (h 512)", 1, 80000, 512, 512),
              ("h x h product, implicit conv (h 256)", 1, 80000, 256, 256),
              ("weight gradient, flagship", 0, 512, 512, 80000),
              ("weight gradient, implicit conv", 0, 256, 256, 80000))


def wgrad_splits(M, N, K, bk=32, units=264):
    """The split count csrc/dsm_sgemm.cuh wgrad_splits gives."""
    cdiv = lambda x, y: -(-x // y)
    split_len = lambda S: max(bk, cdiv(cdiv(K, S), bk) * bk)
    S = max(1, min(units // (cdiv(M, 128) * cdiv(N, 128)), cdiv(K, 16 * bk)))
    return max(1, cdiv(K, split_len(S)))


def cmd_core(a):
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cs, _, fd, _, native = import_port(a.tree)
    native.build(["fused_dsm"])
    lib, _ = fd.build_library()
    card = cs.card_line()
    stream = torch.cuda.current_stream().cuda_stream
    for prec, pname in ((0, "fp32 (3xTF32)"), (1, "bf16")):
        for what, kc, M, N, K in CORE_CASES:
            S = 1 if kc else wgrad_splits(M, N, K)
            x = torch.randn((M, K) if kc else (K, M), device="cuda")
            y = torch.randn((N, K) if kc else (K, N), device="cuda")
            c = torch.empty(S * M * N, device="cuda")
            scratch = torch.empty(2 * N * K + 64, device="cuda")

            def run():
                if lib.dsm_sgemm_probe(kc, prec, M, N, K, S, x.data_ptr(), x.stride(0),
                                       y.data_ptr(), y.stride(0), c.data_ptr(),
                                       scratch.data_ptr(), stream):
                    raise RuntimeError("dsm_sgemm_probe failed")

            ms = cs.time_ms(torch, run, reps=11)
            print(f"core {pname} {what}: M {M} N {N} K {K} splits {S}: {ms:.4f} ms, "
                  f"{2 * M * N * K / ms / 1e9:.1f} TFLOP/s of fp32 products "
                  f"(median of 11; the weight's conversion included) | {card}",
                  flush=True)
    return 0


def cmd_ab(a):
    turns = [("old", a.old), ("new", a.new), ("new", a.new), ("old", a.old)]
    rows = []
    for name, tree in turns:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "time",
                              "--tree", tree], capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout[-3000:], out.stderr[-3000:], sep="\n")
            return out.returncode
        line = json.loads(out.stdout.strip().splitlines()[-1])
        line["turn"] = name
        rows.append(line)
        print(json.dumps(line), flush=True)
    keys = [k for k in rows[0] if k.endswith("_ms") or k.endswith("_ms_step")]
    print("| | " + " | ".join(r["turn"] for r in rows) + " |")
    print("| --- |" + " --- |" * len(rows))
    for k in keys:
        print(f"| {k} | " + " | ".join(f"{r[k]:.3f}" for r in rows) + " |")
    print(rows[0]["card"])
    return 0


def short_name(name):
    """'sgemm_kernel<true, true, FwdEpi, 0>' -> 'sgemm FwdEpi' (the bf16
    products, precision 1: 'sgemm FwdEpi bf16'); 'prep_b_kernel<1>' ->
    'prep_b bf16'; else the bare function name."""
    name = name.replace("(anonymous namespace)::", "")
    m = re.search(r"(\w+)(<[^()]*>)?\(", name)
    if not m:
        return name[:40]
    args = [a.strip() for a in m.group(2)[1:-1].split(",")] if m.group(2) else []
    base = m.group(1).replace("_kernel", "")
    if len(args) >= 2:   # sgemm_kernel<A_KC, B_KC, Epi, PREC>
        *_, epi, prec = args
        return f"{base} {epi}" + (" bf16" if prec == "1" else "")
    return base + (" bf16" if args == ["1"] else "")   # prep_b_kernel<PREC>


def device_events(torch, prof):
    """The device's own work: kernels and copies, without the user-annotation
    ranges (an optimizer's step) that the profiler mirrors onto the device
    timeline over the kernels they enclose."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("Optimizer.")]


def device_table(torch, prof, top):
    """(rows of (kernel name, device ms, calls), device busy ms, span ms)."""
    evs = device_events(torch, prof)
    by = {}
    for e in evs:
        t = by.setdefault(e.name, [0.0, 0])
        t[0] += e.time_range.elapsed_us() / 1e3
        t[1] += 1
    rows = sorted(((n, v[0], v[1]) for n, v in by.items()), key=lambda r: -r[1])
    busy = sum(v[0] for v in by.values())
    if evs:
        span = (max(e.time_range.end for e in evs) - min(e.time_range.start for e in evs)) / 1e3
    else:
        span = 0.0
    return rows[:top], busy, span


def print_profile(torch, prof, what, card, wall_ms=None, top=25, launches=False):
    """The device time by kernel name; with ``launches``, also every launch
    in order."""
    rows, busy, span = device_table(torch, prof, top)
    print(f"== {what}: device busy {busy:.3f} ms of a {span:.3f} ms device span"
          + (f" ({wall_ms:.3f} ms host wall)" if wall_ms else "")
          + f" | {card}", flush=True)
    for name, ms, calls in rows:
        print(f"  {ms:9.3f} ms {calls:5d}x  {name[:150]}", flush=True)
    if launches:
        evs = sorted(device_events(torch, prof), key=lambda e: e.time_range.start)
        print("  launches in order: " + ", ".join(
            f"{short_name(e.name)} {e.time_range.elapsed_us() / 1e3:.3f}"
            for e in evs), flush=True)


def cmd_profile(a):
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cs, cases = kernel_cases(torch, a.tree)
    card = cs.card_line()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for kind, (fn, args) in cases.items():
        leaves = [args[5]] + list(args[6:])
        for _ in range(2):
            cs.grads(torch, fn(*args), leaves)
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            cs.grads(torch, fn(*args), leaves)
            torch.cuda.synchronize()
        print_profile(torch, prof, f"{kind}-style kernel, one forward + backward "
                      f"at its line's shape", card, launches=True)
    del cases
    torch.cuda.empty_cache()
    if a.no_steps:
        return 0

    from ardae_tpu_torch.train import step as step_mod
    inner = step_mod.one_step
    for name, line_args in (("flagship", cs.FLAGSHIP_ARGS),
                            ("implicit-conv", cs.IMPLICIT_CONV_ARGS)):
        state = {"k": 0, "prof": None, "t0": 0.0, "wall": 0.0}

        def traced(*args, **kw):
            state["k"] += 1
            if state["k"] == STEPS - 1:   # one steady step, warmed up
                torch.cuda.synchronize()
                state["prof"] = profile(activities=acts)
                state["prof"].__enter__()
                state["t0"] = time.perf_counter()
                out = inner(*args, **kw)
                torch.cuda.synchronize()
                state["wall"] = (time.perf_counter() - state["t0"]) * 1e3
                state["prof"].__exit__(None, None, None)
                return out
            return inner(*args, **kw)

        step_mod.one_step = traced
        try:
            run_line(cs, torch, line_args)
        finally:
            step_mod.one_step = inner
        print_profile(torch, state["prof"], f"one steady {name} step (step "
                      f"{STEPS - 1} of {STEPS}, --use-kernels)", card, state["wall"])
        torch.cuda.empty_cache()
    return 0


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("time")
    t.add_argument("--tree", default=ROOT)
    b = sub.add_parser("ab")
    b.add_argument("--old", required=True)
    b.add_argument("--new", default=ROOT)
    c = sub.add_parser("core")
    c.add_argument("--tree", default=ROOT)
    f = sub.add_parser("profile")
    f.add_argument("--tree", default=ROOT)
    f.add_argument("--no-steps", action="store_true",
                   help="trace the kernels only, not the lines' steps")
    a = p.parse_args()
    return {"time": cmd_time, "ab": cmd_ab, "core": cmd_core,
            "profile": cmd_profile}[a.cmd](a)


if __name__ == "__main__":
    sys.exit(main())
