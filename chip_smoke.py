"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each failure exits non-zero):
  1. needs a CUDA device; prints the card's name and power limit;
  2. builds the hand-written kernels from ardae_tpu_torch/csrc/ with nvcc for
     sm_90a (into build/), one nvcc per source, all started together; prints
     each kernel instantiation's registers, shared memory and spills (from
     -Xptxas -v) and the GEMM ring's dynamic shared memory, and counts the
     tensor-core instructions (HMMA) in each library's SASS with cuobjdump,
     where the toolkit has it: a count of 0 fails;
  3. holds the res-style fused DSM kernel (forward and backward) against its
     plain PyTorch version, fp32 with TF32 off for every matmul and
     convolution: at the flagship shape (n = 128 x 625 rows, d 32, h 512, 5
     layers, softplus) and at one ragged small shape per activation; at the
     flagship shape it also runs the kernel twice and fails unless loss and
     gradients are bitwise equal;
  3b. the same for the grad-style (second-order) kernel: at the
     implicit-conv line's shape (n = 128 x 625, d 32, h 256, 5 layers,
     softplus) and at ragged small shapes. Bounds for both: loss relative
     error <= 1e-5; every gradient, d/d(ctx_l0) included,
     ||kernel - plain|| / ||plain|| <= 1e-4 (3xTF32 products, fp32 sums in
     another order);
  4. times the res-style kernel and its plain version at the flagship shape,
  4b. and the grad-style pair at the implicit-conv shape (CUDA events,
     warm-up, median of 7, in the order plain, kernel, kernel, plain), and
     the chain's matrix products alone as torch.matmul calls (fp32, TF32
     off: the yardstick library_ms, which the port never calls);
  5. drives the main path, cli.ivae_ardae with the flags of the flagship
     dbMNIST line (scripts/run_vae_dbmnist.sh:35) plus --use-kernels, for 6
     steps,
  5b. and with the flags of the implicit-conv line (:41, mnist-conv +
     mlp-grad) plus --use-kernels, for 6 steps. Each run starts with every
     launch counter at 0 and checks that its kernel launched once per cdae
     update and the other kernel never, that every logged loss is finite,
     that the parameters moved, and that the trained encoder gives finite
     latents of the expected shape.
Then it prints the kernels' JSON line (each kernel's launches on the main
path, error, times, FLOP, launches per step, and its bound: the larger of
3 x FLOP over the 495 TFLOP/s TF32 tensor-core peak, the kernel's products
being 3xTF32, and its inputs' and outputs' bytes over 3.35 TB/s; beside it
the fp32 CUDA-core bound, FLOP over 67 TFLOP/s; H100 SXM peaks at 700 W),
the card line, and as its last line {"ok": true, "device": {...}}.
"""

import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

FLAGSHIP_ARGS = [
    "--dataset", "dbmnist-val5k", "--nheight", "28", "--nchannels", "1",
    "--train-batch-size", "128", "--eval-batch-size", "1",
    "--m-optimizer", "adam", "--m-momentum", "0.9", "--m-beta1", "0.9",
    "--d-optimizer", "rmsprop", "--d-momentum", "0.9", "--d-beta1", "0.9",
    "--train-nstd-cdae", "1", "--train-nz-cdae", "625", "--train-nz-model", "1",
    "--model", "resconvct-res", "--model-z-dim", "32", "--model-h-dim", "512",
    "--model-n-layers", "1", "--model-nonlin", "elu", "--model-n-dim", "100",
    "--model-clip-z0-logvar", "none", "--model-clip-z-logvar", "none",
    "--cdae", "mlp-res", "--cdae-h-dim", "512", "--cdae-n-layers", "5",
    "--cdae-nonlin", "softplus", "--cdae-ctx-type", "lt0", "--exp-num", "1",
    "--m-lr", "0.001", "--d-lr", "0.0001", "--beta-init", "1.0",
    "--beta-fin", "1.0", "--beta-annealing", "0", "--delta", "0.1",
    "--std-scale", "100", "--num-cdae-updates", "2", "--epochs", "6400",
    "--iws-samples", "256", "--m-weight-avg", "none",
    "--m-weight-avg-start", "-1", "--m-weight-avg-decay", "0.998",
    "--vis-interval", "50000", "--train-mode", "train",
]
IMPLICIT_CONV_ARGS = [
    "--dataset", "dbmnist-val5k", "--nheight", "28", "--nchannels", "1",
    "--train-batch-size", "128", "--eval-batch-size", "1",
    "--m-optimizer", "adam", "--m-momentum", "0.5", "--m-beta1", "0.5",
    "--d-optimizer", "rmsprop", "--d-momentum", "0.5", "--d-beta1", "0.5",
    "--train-nstd-cdae", "1", "--train-nz-cdae", "625", "--train-nz-model", "1",
    "--model", "mnist-conv", "--model-z-dim", "32", "--model-h-dim", "0",
    "--model-n-layers", "0", "--model-nonlin", "softplus", "--model-n-dim", "100",
    "--model-clip-z0-logvar", "none", "--model-clip-z-logvar", "none",
    "--cdae", "mlp-grad", "--cdae-h-dim", "256", "--cdae-n-layers", "5",
    "--cdae-nonlin", "softplus", "--cdae-ctx-type", "lt0", "--exp-num", "1",
    "--m-lr", "0.0001", "--d-lr", "0.0001", "--beta-init", "1.0",
    "--beta-fin", "1.0", "--beta-annealing", "0", "--delta", "0.1",
    "--std-scale", "10000", "--num-cdae-updates", "1", "--epochs", "6400",
    "--iws-samples", "1024", "--m-weight-avg", "none",
    "--m-weight-avg-start", "-1", "--m-weight-avg-decay", "0.998",
    "--vis-interval", "50000", "--train-mode", "train",
]
SMOKE_ARGS = ["--use-kernels", "--max-iters", "6", "--log-interval", "2",
              "--eval-iws-interval", "0", "--ckpt-interval", "0",
              "--skip-final-test-eval", "--no-resume"]
STEPS = 6
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
TF32_FLOPS, FP32_FLOPS, HBM_BYTES = 495e12, 67e12, 3.35e12   # H100 SXM, 700 W


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def ptxas_report(log):
    """[(kernel, registers, static smem bytes, spill stores, spill loads)]
    of every entry function in an nvcc -Xptxas -v log."""
    rows = []
    for block in re.split(r"Compiling entry function '", log)[1:]:
        name = block.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", block)
        smem = re.search(r"(\d+) bytes smem", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
        rows.append((name, int(regs.group(1)) if regs else -1,
                     int(smem.group(1)) if smem else 0,
                     int(spill.group(1)) if spill else -1,
                     int(spill.group(2)) if spill else -1))
    filt = shutil.which("c++filt")
    if filt and rows:
        out = subprocess.run([filt], input="\n".join(r[0] for r in rows),
                             capture_output=True, text=True, timeout=60).stdout
        names = out.splitlines()
        if len(names) == len(rows):
            rows = [(n.replace("(anonymous namespace)::", "").split("(")[0].replace(
                "void ", ""),) + r[1:] for n, r in zip(names, rows)]
    return rows


def hmma_count(lib):
    """HMMA instructions in a library's SASS, or None without cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                         timeout=300)
    if out.returncode != 0:
        fail(f"cuobjdump -sass {lib} failed: {out.stderr[-2000:]}")
    return sum("HMMA" in ln for ln in out.stdout.splitlines())


def products(kind, args):
    """The matrix products of one kernel entry point, (op, layer), op one of
    forward (x . W^T), input_grad (dp . W), weight_grad (dp^T . h): the res
    kernel's layers all; the grad kernel's hidden layers (its h -> 1 head
    has no product). Returns ({"fwd": [...], "bwd": [...]}, [(out, in)])."""
    ws, l0 = args[6::2], args[1]
    dims = [(w.shape[0], w.shape[1] - (i == l0)) for i, w in enumerate(ws)]
    layers = range(len(dims) if kind == "res" else len(dims) - 1)
    fwd = [("forward", i) for i in layers]
    dgrad = [("input_grad", i) for i in layers if i > 0]
    wgrad = [("weight_grad", i) for i in layers]
    if kind == "res":
        return {"fwd": fwd, "bwd": wgrad + dgrad}, dims
    # grad style: forward + input-gradient chain (down to d e / d xbar);
    # tangent chain + two weight-gradient products a layer + primal adjoint
    return {"fwd": fwd + dgrad + [("input_grad", 0)],
            "bwd": fwd + wgrad + wgrad + dgrad}, dims


def flops(kind, args):
    ops, dims = products(kind, args)
    n = args[2].shape[0]
    return {w: sum(2.0 * n * dims[i][0] * dims[i][1] for _, i in ops[w])
            for w in ops}


def io_bytes(args, leaves):
    """Bytes the function must move: each input read once and each output
    written once (fwd: inputs -> loss; bwd: inputs and the cotangent ->
    every gradient)."""
    inputs = sum(t.numel() for t in args[2:]) * 4
    return {"fwd": inputs + 4, "bwd": inputs + 4 + sum(t.numel() for t in leaves) * 4}


def library_ms(torch, kind, args):
    """Median ms of the entry points' matrix products alone, as
    torch.matmul calls on operands of the kernel's shapes (fp32, TF32 off)."""
    ops, dims = products(kind, args)
    ws, n, dev = args[6::2], args[2].shape[0], args[2].device
    width = max(max(o, i) for o, i in dims)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(n, width, generator=g, device=dev)
    y = torch.randn(n, width, generator=g, device=dev)

    def run(which):
        for op, i in ops[which]:
            out, inn = dims[i]
            w = ws[i][:, :inn].detach()
            if op == "forward":
                torch.matmul(x[:, :inn], w.t())
            elif op == "input_grad":
                torch.matmul(x[:, :out], w)
            else:
                torch.matmul(x[:, :out].t(), y[:, :inn])

    return {w: time_ms(torch, lambda: run(w)) for w in ("fwd", "bwd")}


def dsm_case(prepare, build_cdae, torch, dev, cdae_name, bsz, ssz, d, h,
             layers, act, seed):
    """Inputs of a DSM chain for one shape, made on the card from a seed."""
    cdae = build_cdae(cdae_name, input_dim=d, context_dim=d, h_dim=h,
                      n_layers=layers, nonlin=act, seed=seed, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    latent = torch.randn(bsz, ssz, d, generator=g, device=dev)
    ctx = torch.randn(bsz, d, generator=g, device=dev)
    std = 0.3 * torch.randn(bsz, ssz, 1, generator=g, device=dev).abs()
    act, l0, xbar, eps, sigma, _, flat = prepare(cdae, latent, ctx, std, g, None)
    ctx_l0 = cdae.ctx_l0(ctx).detach().requires_grad_(True)
    flat = [w.detach().requires_grad_(True) for w in flat]
    return (act, l0, xbar, eps, sigma, ctx_l0, *flat)


def grads(torch, loss, leaves, **kw):
    """d loss / d leaves; a leaf the loss does not reach (the grad-style
    energy head's bias) gets zeros, as the kernel returns."""
    gs = torch.autograd.grad(loss, leaves, allow_unused=True, **kw)
    return [torch.zeros_like(x) if g is None else g for g, x in zip(gs, leaves)]


def compare(torch, kernel, plain, args):
    """Kernel vs plain on the same inputs: (loss rel err, loss abs err,
    worst grad rel-norm err, worst grad abs err)."""
    leaves = [args[5]] + list(args[6:])
    outs = []
    for fn in (kernel, plain):
        loss = fn(*args)
        gs = grads(torch, loss, leaves)
        torch.cuda.synchronize()
        outs.append((loss.detach(), gs))
    (lk, gk), (lr, gr) = outs
    for t in [lk, *gk]:
        if not bool(torch.isfinite(t).all()):
            fail("kernel produced non-finite values")
    rel = [float((a - b).norm() / b.norm()) if float(b.norm()) else float(a.norm())
           for a, b in zip(gk, gr)]
    absd = [float((a - b).abs().max()) for a, b in zip(gk, gr)]
    return (abs(float(lk) - float(lr)) / abs(float(lr)), abs(float(lk) - float(lr)),
            max(rel), max(absd))


def time_ms(torch, fn, reps=7):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def check_kernel(torch, dev, build_cdae, k, what):
    """Phase 3/3b: kernel vs plain at the ragged shapes and the line's
    shape; returns the line's inputs and its (loss abs err, grad abs err)."""
    for bsz, ssz, d, h, layers, act, seed in k["ragged"]:
        args = dsm_case(k["prepare"], build_cdae, torch, dev, k["cdae"], bsz, ssz,
                        d, h, layers, act, seed)
        lrel, _, grel, _ = compare(torch, k["fn"].apply, k["plain"], args)
        print(f"{what} compare {k['cdae']} n={bsz}x{ssz} d={d} h={h} "
              f"layers={layers} {act}: loss rel {lrel:.2e}, worst grad rel-norm "
              f"{grel:.2e}", flush=True)
        if not (lrel <= LOSS_RTOL and grel <= GRAD_RTOL):
            fail(f"{k['cdae']} kernel disagrees with the plain version ({act}, h={h})")
    bsz, ssz, d, h, layers, act, seed = k["line"]
    args = dsm_case(k["prepare"], build_cdae, torch, dev, k["cdae"], bsz, ssz, d,
                    h, layers, act, seed)
    lrel, labs, grel, gabs = compare(torch, k["fn"].apply, k["plain"], args)
    print(f"{what} compare {k['cdae']} at the {k['line_name']} shape n={bsz}x{ssz} "
          f"d={d} h={h} layers={layers} {act}: loss rel {lrel:.2e} (abs "
          f"{labs:.2e}), worst grad rel-norm {grel:.2e} (max abs {gabs:.2e})",
          flush=True)
    if not (lrel <= LOSS_RTOL and grel <= GRAD_RTOL):
        fail(f"{k['cdae']} kernel disagrees with the plain version at the "
             f"{k['line_name']} shape")
    leaves = [args[5]] + list(args[6:])
    runs = []
    for _ in range(2):
        loss = k["fn"].apply(*args)
        runs.append([loss.detach()] + grads(torch, loss, leaves))
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        fail(f"{k['cdae']} kernel is not bitwise repeatable at the "
             f"{k['line_name']} shape")
    print(f"{what} repeat {k['cdae']} at the {k['line_name']} shape: loss and "
          f"{len(leaves)} gradients bitwise equal over two runs", flush=True)
    return args, labs, gabs


def time_kernel(torch, k, args, what, card):
    """Phase 4/4b: median ms of fwd, bwd and fwd+bwd, kernel and plain, in
    turns plain, kernel, kernel, plain."""
    leaves = [args[5]] + list(args[6:])
    times = {}
    for name, fn in [("plain", k["plain"]), ("kernel", k["fn"].apply)] * 2:
        loss = fn(*args)
        fwd = time_ms(torch, lambda: fn(*args))
        bwd = time_ms(torch, lambda: grads(torch, loss, leaves, retain_graph=True))
        both = time_ms(torch, lambda: grads(torch, fn(*args), leaves))
        times.setdefault(name, []).append((fwd, bwd, both))
        del loss
    med = {n: [statistics.median(x[i] for x in v) for i in range(3)]
           for n, v in times.items()}
    lib = library_ms(torch, k["kind"], args)
    med["library"] = [lib["fwd"], lib["bwd"], lib["fwd"] + lib["bwd"]]
    fl = flops(k["kind"], args)
    print(f"{what} time {k['cdae']} at the {k['line_name']} shape (median of 7, "
          f"two turns each): kernel fwd {med['kernel'][0]:.3f} ms bwd "
          f"{med['kernel'][1]:.3f} ms fwd+bwd {med['kernel'][2]:.3f} ms | plain "
          f"fwd {med['plain'][0]:.3f} ms bwd {med['plain'][1]:.3f} ms fwd+bwd "
          f"{med['plain'][2]:.3f} ms | products alone (torch.matmul fp32) fwd "
          f"{lib['fwd']:.3f} ms bwd {lib['bwd']:.3f} ms | kernel "
          f"{fl['fwd'] / med['kernel'][0] / 1e9:.1f} / "
          f"{fl['bwd'] / med['kernel'][1] / 1e9:.1f} TFLOP/s fwd / bwd | {card}",
          flush=True)
    return med


def drive_line(torch, dev, k, line_args, model, build_ivae_model, build_cdae,
               kernels, what, card):
    """Phase 5/5b: STEPS steps of a line through cli.ivae_ardae.run with
    --use-kernels; every launch counter is 0 just before and read just
    after. Returns this kernel's launches."""
    from ardae_tpu_torch.cli import ivae_ardae
    from ardae_tpu_torch.models.ivae import api as ivae_api

    with tempfile.TemporaryDirectory() as tmp:
        argv = line_args + SMOKE_ARGS + [
            "--cache", os.path.join(tmp, "exp"),
            "--data-root", os.path.join(tmp, "data")]
        for other in kernels:
            for name in other["fn"].launches:
                other["fn"].launches[name] = 0
        t0 = time.perf_counter()
        state, path = ivae_ardae.run(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: c for other in kernels
                    for n, c in other["fn"].launches.items()}
        with open(os.path.join(path, "log.txt")) as f:
            lines = [ln for ln in f if ln.startswith("| iter ")]
    expected = {n: (STEPS * k["updates"] if n in k["fn"].launches else 0)
                for n in launches}
    if launches != expected:
        fail(f"{k['line_name']} line: kernel launches {launches}, expected {expected}")
    if len(lines) != STEPS // 2:
        fail(f"expected {STEPS // 2} log lines, got {len(lines)}")
    losses = [float(v) for ln in lines for v in re.findall(
        r"loss \([a-z]+\) (\S+)", ln)]
    if not losses or not all(math.isfinite(v) for v in losses):
        fail(f"non-finite logged losses: {losses}")
    ms_step = [float(re.search(r"ms/step\s+(\S+)", ln).group(1)) for ln in lines]
    init_m = build_ivae_model(**model, seed=0, device=dev)
    init_d = build_cdae(k["cdae"], input_dim=32, context_dim=32, h_dim=k["line"][3],
                        n_layers=5, nonlin="softplus", seed=1, device=dev)
    for a, b, who in ((state.model, init_m, "model"), (state.cdae, init_d, "cdae")):
        moved = sum(float((p.detach() - q.detach()).abs().max()) > 0
                    for p, q in zip(a.parameters(), b.parameters()))
        total = len(list(a.parameters()))
        print(f"{what} {who}: {moved}/{total} parameter tensors moved", flush=True)
        if moved == 0:
            fail(f"{who} parameters did not change")
    with torch.no_grad():
        x = (torch.rand(8, 784, device=dev) < 0.3).float()
        z = ivae_api.encode_det(state.model, x)
    if tuple(z.shape) != (8, 1, 32) or not bool(torch.isfinite(z).all()):
        fail(f"trained encoder output {tuple(z.shape)} not finite/(8, 1, 32)")
    print(f"{what} main path: {STEPS} steps of the {k['line_name']} line with "
          f"--use-kernels in {wall:.1f} s (set-up included); ms/step per log "
          f"interval {ms_step}; steady {ms_step[-1]:.2f} ms/step = "
          f"{1000.0 / ms_step[-1]:.3f} steps/s; kernel launches {launches}; "
          f"losses finite | {card}", flush=True)
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from ardae_tpu_torch.models.registry import build_cdae, build_ivae_model
        from ardae_tpu_torch.ops import fused_dsm as fd
        from ardae_tpu_torch.ops import fused_dsm_grad as fg
        from ardae_tpu_torch.ops import native
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 2

    card = card_line()
    dev = torch.device("cuda")
    print(f"phase 1 device: {torch.cuda.get_device_name(0)} | {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    res = {"cdae": "mlp-res", "kind": "res", "fn": fd.FusedDSMFunction,
           "plain": fd.dsm_chain_reference, "prepare": fd.prepare_inputs,
           "line_name": "flagship", "updates": 2,
           "ragged": [(3, 37, 5, 24, 2, a, 1) for a in ("softplus", "relu", "tanh")]
           + [(4, 300, 32, 136, 3, "tanh", 2)],
           "line": (128, 625, 32, 512, 5, "softplus", 3)}
    grad = {"cdae": "mlp-grad", "kind": "grad", "fn": fg.FusedDSMGradFunction,
            "plain": fg.dsm_grad_chain_reference, "prepare": fd.prepare_inputs,
            "line_name": "implicit-conv", "updates": 1,
            "ragged": [(3, 37, 5, 24, 2, a, 1) for a in ("softplus", "relu", "tanh")]
            + [(4, 50, 32, 136, 3, "tanh", 2)],
            "line": (128, 625, 32, 256, 5, "softplus", 3)}
    kernels = (res, grad)

    t0 = time.perf_counter()
    info = native.build(["fused_dsm", "fused_dsm_grad"])
    fd.build_library()
    fg.build_library()
    for name, inf in info.items():
        print(f"phase 2 build {name}.cu: nvcc sm_90a {inf['seconds']:.1f} s "
              f"(built now: {inf['built']})", flush=True)
        for kname, regs, smem, st, ld in ptxas_report(inf["log"]):
            print(f"phase 2   {kname}: {regs} registers, {smem} B static smem, "
                  f"spills {st} B stored / {ld} B loaded", flush=True)
    lib, _ = fd.build_library()
    ring = {f"{'K' if a else 'MN'}-contiguous A, {'K' if b else 'MN'}-contiguous B":
            lib.dsm_sgemm_smem_bytes(a, b) for a, b in ((1, 1), (1, 0), (0, 0))}
    print(f"phase 2 GEMM ring dynamic smem per block: {ring}", flush=True)
    for name in info:
        count = hmma_count(native.lib_path(name))
        if count is None:
            print(f"phase 2 {name}: cuobjdump not found, HMMA not counted", flush=True)
            continue
        print(f"phase 2 {name}: {count} HMMA instructions in the SASS", flush=True)
        if count == 0:
            fail(f"{name} has no tensor-core instruction")
    print(f"phase 2 both built and loaded in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # fp32 comparisons: TF32 off for every matmul and convolution
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs, med, work = {}, {}, {}
    for k, what in ((res, "phase 3"), (grad, "phase 3b")):
        args, labs, gabs = check_kernel(torch, dev, build_cdae, k, what)
        errs[k["cdae"]] = (labs, gabs)
        med[k["cdae"]] = time_kernel(torch, k, args, what.replace("3", "4"), card)
        work[k["cdae"]] = (flops(k["kind"], args),
                           io_bytes(args, [args[5]] + list(args[6:])))
        del args
        torch.cuda.empty_cache()

    launches = {}
    for k, what, line_args, model in (
            (res, "phase 5", FLAGSHIP_ARGS,
             dict(name="resconvct-res", nchannels=1, nheight=28, z_dim=32,
                  h_dim=512, n_dim=100, n_layers=1, nonlin="elu")),
            (grad, "phase 5b", IMPLICIT_CONV_ARGS,
             dict(name="mnist-conv", nchannels=1, nheight=28, z_dim=32,
                  h_dim=0, n_dim=100, n_layers=0, nonlin="softplus"))):
        launches.update({n: c for n, c in drive_line(
            torch, dev, k, line_args, model, build_ivae_model, build_cdae, kernels,
            what, card).items() if n in k["fn"].launches})
        torch.cuda.empty_cache()

    def entry(name, k, source, replaces, which):
        m = med[k["cdae"]]
        part = ("fwd", "bwd")[which]
        flop, nbytes = (w[part] for w in work[k["cdae"]])
        ops_ms, bytes_ms = 3 * flop / TF32_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": errs[k["cdae"]][which], "ms": m["kernel"][which],
                "plain_ms": m["plain"][which], "bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "library_ms": m["library"][which], "flop": flop,
                "launches_per_step": k["updates"],
                "fp32_bound_ms": flop / FP32_FLOPS * 1e3}

    grad_sites = ("ardae_tpu/ops/fused_dsm_grad.py:114 and "
                  "ardae_tpu/ops/fused_dsm_grad2.py:90")
    kernels_line = [
        entry("fused_dsm_fwd", res, "ardae_tpu_torch/csrc/fused_dsm.cu",
              "ardae_tpu/ops/fused_dsm.py:123", 0),
        entry("fused_dsm_bwd", res, "ardae_tpu_torch/csrc/fused_dsm.cu",
              "ardae_tpu/ops/fused_dsm.py:139", 1),
        entry("fused_dsm_grad_fwd", grad, "ardae_tpu_torch/csrc/fused_dsm_grad.cu",
              grad_sites, 0),
        entry("fused_dsm_grad_bwd", grad, "ardae_tpu_torch/csrc/fused_dsm_grad.cu",
              grad_sites, 1),
    ]
    print(json.dumps({"kernels": kernels_line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
