"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each failure exits non-zero):
  1. needs a CUDA device; prints the card's name and power limit;
  2. builds the hand-written kernels from ardae_tpu_torch/csrc/ with nvcc for
     sm_90a (into build/);
  3. holds the fused DSM kernel (forward and backward) against its plain
     PyTorch version, fp32 with TF32 off for every matmul and convolution:
     at the flagship shape (n = 128 x 625 rows, d 32, h 512, 5 layers,
     softplus) and at one ragged small shape per activation. Bounds: loss
     relative error <= 1e-5; every gradient, d/d(ctx_l0) included,
     ||kernel - plain|| / ||plain|| <= 1e-4 (fp32 sums in another order);
  4. times kernel and plain version at the flagship shape (CUDA events,
     warm-up, median of 7, in the order plain, kernel, kernel, plain);
  5. drives the main path, cli.ivae_ardae with the flags of the flagship
     dbMNIST line (scripts/run_vae_dbmnist.sh) plus --use-kernels, for 6
     steps, and checks that the kernel launched on every cdae update, that
     every logged loss is finite, that the parameters moved, and that the
     trained encoder gives finite latents of the expected shape.
Then it prints the kernels' JSON line, the card line, and as its last line
{"ok": true, "device": {...}}.
"""

import json
import math
import os
import re
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
SMOKE_ARGS = ["--use-kernels", "--max-iters", "6", "--log-interval", "2",
              "--eval-iws-interval", "0", "--ckpt-interval", "0",
              "--skip-final-test-eval", "--no-resume"]
STEPS, UPDATES = 6, 2
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def dsm_case(fd, build_cdae, torch, dev, bsz, ssz, d, h, layers, act, seed):
    """Inputs of the DSM chain for one shape, made on the card from a seed."""
    cdae = build_cdae("mlp-res", input_dim=d, context_dim=d, h_dim=h,
                      n_layers=layers, nonlin=act, seed=seed, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    latent = torch.randn(bsz, ssz, d, generator=g, device=dev)
    ctx = torch.randn(bsz, d, generator=g, device=dev)
    std = 0.3 * torch.randn(bsz, ssz, 1, generator=g, device=dev).abs()
    act, l0, xbar, eps, sigma, _, flat = fd._prepare(cdae, latent, ctx, std, g, None)
    ctx_l0 = cdae.ctx_l0(ctx).detach().requires_grad_(True)
    flat = [w.detach().requires_grad_(True) for w in flat]
    return (act, l0, xbar, eps, sigma, ctx_l0, *flat)


def compare(fd, torch, args):
    """Kernel vs plain on the same inputs: (loss rel err, loss abs err,
    worst grad rel-norm err, worst grad abs err)."""
    leaves = [args[5]] + list(args[6:])
    outs = []
    for fn in (fd.FusedDSMFunction.apply, fd.dsm_chain_reference):
        loss = fn(*args)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        outs.append((loss.detach(), grads))
    (lk, gk), (lr, gr) = outs
    for t in [lk, *gk]:
        if not bool(torch.isfinite(t).all()):
            fail("kernel produced non-finite values")
    rel = [float((a - b).norm() / b.norm().clamp_min(1e-30)) for a, b in zip(gk, gr)]
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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from ardae_tpu_torch.cli import ivae_ardae
        from ardae_tpu_torch.models.registry import build_cdae, build_ivae_model
        from ardae_tpu_torch.models.ivae import api as ivae_api
        from ardae_tpu_torch.ops import fused_dsm as fd
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 2

    card = card_line()
    dev = torch.device("cuda")
    print(f"phase 1 device: {torch.cuda.get_device_name(0)} | {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    _, info = fd.build_library()
    regs = re.findall(r"Used (\d+) registers", info["log"])
    print(f"phase 2 build: nvcc sm_90a {info['seconds']:.1f} s "
          f"(loaded in {time.perf_counter() - t0:.1f} s); registers per "
          f"kernel {regs}", flush=True)

    # fp32 comparisons: TF32 off for every matmul and convolution
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shapes = [(3, 37, 5, 24, 2, a, 1) for a in ("softplus", "relu", "tanh")]
    shapes += [(4, 300, 32, 136, 3, "tanh", 2)]
    for bsz, ssz, d, h, layers, act, seed in shapes:
        args = dsm_case(fd, build_cdae, torch, dev, bsz, ssz, d, h, layers, act, seed)
        lrel, _, grel, _ = compare(fd, torch, args)
        print(f"phase 3 compare n={bsz}x{ssz} d={d} h={h} layers={layers} {act}: "
              f"loss rel {lrel:.2e}, worst grad rel-norm {grel:.2e}", flush=True)
        if not (lrel <= LOSS_RTOL and grel <= GRAD_RTOL):
            fail(f"kernel disagrees with the plain version ({act}, h={h})")
    flag = dsm_case(fd, build_cdae, torch, dev, 128, 625, 32, 512, 5, "softplus", 3)
    lrel, labs, grel, gabs = compare(fd, torch, flag)
    print(f"phase 3 compare flagship n=128x625 d=32 h=512 layers=5 softplus: "
          f"loss rel {lrel:.2e} (abs {labs:.2e}), worst grad rel-norm "
          f"{grel:.2e} (max abs {gabs:.2e})", flush=True)
    if not (lrel <= LOSS_RTOL and grel <= GRAD_RTOL):
        fail("kernel disagrees with the plain version at the flagship shape")

    leaves = [flag[5]] + list(flag[6:])
    times = {}
    for name, fn in [("plain", fd.dsm_chain_reference),
                     ("kernel", fd.FusedDSMFunction.apply)] * 2:
        loss = fn(*flag)
        fwd = time_ms(torch, lambda: fn(*flag))
        bwd = time_ms(torch, lambda: torch.autograd.grad(loss, leaves,
                                                         retain_graph=True))
        both = time_ms(torch, lambda: torch.autograd.grad(fn(*flag), leaves))
        times.setdefault(name, []).append((fwd, bwd, both))
        del loss
    med = {k: [statistics.median(x[i] for x in v) for i in range(3)]
           for k, v in times.items()}
    print(f"phase 4 time flagship (median of 7, two turns each): kernel fwd "
          f"{med['kernel'][0]:.3f} ms bwd {med['kernel'][1]:.3f} ms fwd+bwd "
          f"{med['kernel'][2]:.3f} ms | plain fwd {med['plain'][0]:.3f} ms bwd "
          f"{med['plain'][1]:.3f} ms fwd+bwd {med['plain'][2]:.3f} ms | {card}",
          flush=True)
    del flag, leaves
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        argv = FLAGSHIP_ARGS + SMOKE_ARGS + [
            "--cache", os.path.join(tmp, "exp"),
            "--data-root", os.path.join(tmp, "data")]
        for k in fd.FusedDSMFunction.launches:
            fd.FusedDSMFunction.launches[k] = 0
        t0 = time.perf_counter()
        state, path = ivae_ardae.run(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(fd.FusedDSMFunction.launches)
        with open(os.path.join(path, "log.txt")) as f:
            lines = [ln for ln in f if ln.startswith("| iter ")]
    expected = STEPS * UPDATES
    if launches != {"fused_dsm_fwd": expected, "fused_dsm_bwd": expected}:
        fail(f"kernel launches {launches}, expected {expected} of each")
    if len(lines) != STEPS // 2:
        fail(f"expected {STEPS // 2} log lines, got {len(lines)}")
    losses = [float(v) for ln in lines for v in re.findall(
        r"loss \([a-z]+\) (\S+)", ln)]
    if not losses or not all(math.isfinite(v) for v in losses):
        fail(f"non-finite logged losses: {losses}")
    ms_step = [float(re.search(r"ms/step\s+(\S+)", ln).group(1)) for ln in lines]
    init_m = build_ivae_model("resconvct-res", nchannels=1, nheight=28, z_dim=32,
                              h_dim=512, n_dim=100, n_layers=1, nonlin="elu",
                              seed=0, device=dev)
    init_d = build_cdae("mlp-res", input_dim=32, context_dim=32, h_dim=512,
                        n_layers=5, nonlin="softplus", seed=1, device=dev)
    for a, b, what in ((state.model, init_m, "model"), (state.cdae, init_d, "cdae")):
        moved = sum(float((p.detach() - q.detach()).abs().max()) > 0
                    for p, q in zip(a.parameters(), b.parameters()))
        total = len(list(a.parameters()))
        print(f"phase 5 {what}: {moved}/{total} parameter tensors moved", flush=True)
        if moved == 0:
            fail(f"{what} parameters did not change")
    with torch.no_grad():
        x = (torch.rand(8, 784, device=dev) < 0.3).float()
        z = ivae_api.encode_det(state.model, x)
    if tuple(z.shape) != (8, 1, 32) or not bool(torch.isfinite(z).all()):
        fail(f"trained encoder output {tuple(z.shape)} not finite/(8, 1, 32)")
    print(f"phase 5 main path: {STEPS} steps of the flagship line with "
          f"--use-kernels in {wall:.1f} s (set-up included); ms/step per log "
          f"interval {ms_step}; steady {1000.0 / ms_step[-1]:.3f} steps/s; "
          f"kernel launches {launches}; losses finite | {card}", flush=True)

    kernels = [
        {"name": "fused_dsm_fwd", "route": "cuda",
         "source": "ardae_tpu_torch/csrc/fused_dsm.cu",
         "replaces": "ardae_tpu/ops/fused_dsm.py:123",
         "launches": launches["fused_dsm_fwd"], "max_abs_err": labs,
         "ms": med["kernel"][0], "plain_ms": med["plain"][0]},
        {"name": "fused_dsm_bwd", "route": "cuda",
         "source": "ardae_tpu_torch/csrc/fused_dsm.cu",
         "replaces": "ardae_tpu/ops/fused_dsm.py:139",
         "launches": launches["fused_dsm_bwd"], "max_abs_err": gabs,
         "ms": med["kernel"][1], "plain_ms": med["plain"][1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
