"""The port's data and sample parallelism with a card a rank (NCCL),
against a world of one.

    python3 scripts/torch_mesh_cards.py                    # every card (>= 4)
    python3 scripts/torch_mesh_cards.py --no-cuda --ranks 4   # CPU, gloo

On a mesh of N ranks (the machine's cards; with --no-cuda, N CPU processes
at a cut width: bs 8, nz 10, h 32, as a rehearsal):
  1. graft_entry.dryrun_multichip(N): one joint step on make_mesh(N), then
     on (N/2, 2);
  2. the flagship line (scripts/run_vae_dbmnist.sh:35) with --use-kernels
     on make_mesh(N), 4 steps through parallel/workers.py, and
  3. implicit conv (:41) on sample_parallel_mesh(N/2, 2), its nz_cdae 625
     cut to the nearest multiple of 2 below (624) so that the sample axis
     splits (625 = 5^4 splits over no even count), each against the
     world of one and the plain version's world of one with chip_smoke.py
     phase 11's bounds (PAR_METRICS, PAR_FLOOR, twice the control) and
     its deterministic algorithms: the
     kernel's rows a launch, its launches a rank, every rank's ms/step, and
     rank 0's collectives, each call timed with the card synchronised
     before and after (median ms a call, calls a step);
  4. the drivers with --dp-devices N: cli.ivae_ardae on the flagship's
     flags with --use-kernels and cli.vae on the conv baseline's (:22), 4
     steps each: the mesh line names the backend, every logged loss is
     finite, the kernel launches a step on rank 0 as on one card.
Each prints a line with the card's name and power limit; the last line is
one JSON object of the numbers. Without a card and without --no-cuda it
exits 2.
"""

import argparse
import json
import math
import os
import re
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

SMALL = dict(train_batch_size="8", train_nz_cdae="10", cdae_h_dim="32")


class CollectiveClock:
    """Times this process's (rank 0's) collectives of parallel/mesh.py, the
    device synchronised before and after each call."""

    NAMES = ("average_grads", "reduce_metrics", "sample_sum")

    def __init__(self, torch):
        self.torch, self.ms = torch, {n: [] for n in self.NAMES}

    def __enter__(self):
        from ardae_tpu_torch.parallel.mesh import Mesh

        torch, self.real = self.torch, {n: getattr(Mesh, n) for n in self.NAMES}

        def timed(name, real):
            def call(mesh, *args):
                sync = (lambda: torch.cuda.synchronize(mesh.device)
                        if mesh.device.type == "cuda" else None)
                sync()
                t0 = time.perf_counter()
                out = real(mesh, *args)
                sync()
                self.ms[name].append(1e3 * (time.perf_counter() - t0))
                return out
            return call

        for n, real in self.real.items():
            setattr(Mesh, n, timed(n, real))
        return self

    def __exit__(self, *exc):
        from ardae_tpu_torch.parallel.mesh import Mesh

        for n, real in self.real.items():
            setattr(Mesh, n, real)

    def summary(self, steps):
        return {n: {"median_ms": round(statistics.median(v), 3),
                    "calls_a_step": len(v) / steps}
                for n, v in self.ms.items() if v}


def mesh_line(torch, kernels, k, line_args, what, devices, dp, sp, card):
    """chip_smoke.py's phase 11a / 11b harness on ``devices``, with rank 0's
    collectives timed."""
    clock = CollectiveClock(torch)
    out = cs.drive_mesh_line(torch, kernels, k, line_args, what, dp, sp, card,
                             devices, clock)
    out["collectives"] = clock.summary(cs.PAR_STEPS)
    print(f"{what}: rank 0's collectives {out['collectives']} | {card}", flush=True)
    return out


def driver_runs(kernels, n, small, card):
    """Both drivers with --dp-devices n, 4 steps; rank 0's launches must
    be the res kernel's 2 + 2 a step (the implicit driver) or none."""
    from ardae_tpu_torch.cli import ivae_ardae, vae

    out = {}
    for name, driver, args in (
            ("ivae", ivae_ardae, cs.FLAGSHIP_ARGS + ["--use-kernels"]),
            ("vae", vae, cs.BASELINE_LINES["conv"])):
        with tempfile.TemporaryDirectory() as tmp:
            argv = args + cs.SMOKE_ARGS + [
                "--max-iters", "4", "--dp-devices", str(n),
                "--cache", os.path.join(tmp, "exp"),
                "--data-root", os.path.join(tmp, "d")]
            if small:
                argv = cs.with_flags(argv, train_batch_size="8") + ["--no-cuda"]
            cs.reset_counts(kernels)
            _, path = driver.run(argv)
            launches = cs.read_counts(kernels)
            with open(os.path.join(path, "log.txt")) as f:
                log = f.read()
        mesh = [ln for ln in log.splitlines() if "mesh over" in ln]
        losses = [float(v) for v in re.findall(r"loss(?: \(\w+\))? (\S+)", log)]
        ms = [float(v) for v in re.findall(r"ms/step\s+(\S+)", log)]
        res = 0 if small or name == "vae" else 8
        want = {k: (res if k in ("fused_dsm_fwd", "fused_dsm_bwd") else 0)
                for k in launches}
        if (len(mesh) != 1 or not losses or not all(map(math.isfinite, losses))
                or launches != want):
            cs.fail(f"driver {name}: mesh lines {mesh}, losses {losses}, "
                    f"launches {launches}")
        print(f"driver {name} --dp-devices {n}: {mesh[0]}; rank 0's kernel "
              f"launches {launches}; ms/step per log interval {ms}; losses "
              f"finite | {card}", flush=True)
        out[name] = {"mesh": mesh[0], "launches_rank0": launches, "ms_step": ms}
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-cuda", action="store_true")
    ap.add_argument("--ranks", type=int, default=None)
    opt = ap.parse_args()
    import torch

    from ardae_tpu_torch import graft_entry
    from ardae_tpu_torch.ops import fused_dsm as fd
    from ardae_tpu_torch.ops import fused_dsm_grad as fg
    from ardae_tpu_torch.ops import native

    res = {"fn": fd.FusedDSMFunction, "updates": 2, "kind": "res"}
    grad = {"fn": fg.FusedDSMGradFunction, "updates": 1, "kind": "grad"}
    kernels = (res, grad)
    if opt.no_cuda:
        n, devices, card = opt.ranks or 4, ["cpu"] * (opt.ranks or 4), "cpu"
        cs.FLAGSHIP_ARGS = cs.with_flags(cs.FLAGSHIP_ARGS, model_h_dim="32", **SMALL)
        cs.IMPLICIT_CONV_ARGS = cs.with_flags(cs.IMPLICIT_CONV_ARGS, **SMALL)
    else:
        if not torch.cuda.is_available():
            print("torch_mesh_cards: no CUDA device", file=sys.stderr)
            return 2
        n = torch.cuda.device_count()
        devices, card = [f"cuda:{r}" for r in range(n)], cs.card_line()
        native.build(["fused_dsm", "fused_dsm_grad"])
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    graft_entry.dryrun_multichip(n, devices=devices)
    print(f"dry run on {devices} in {time.perf_counter() - t0:.1f} s | {card}",
          flush=True)
    out = {"card": card, "devices": devices}
    out["flagship"] = mesh_line(torch, kernels, res, cs.FLAGSHIP_ARGS,
                                "flagship (:35)", devices, n, 1, card)
    nz = int(cs.flag(cs.IMPLICIT_CONV_ARGS, "--train-nz-cdae"))
    conv_args = cs.with_flags(cs.IMPLICIT_CONV_ARGS, train_nz_cdae=str(nz - nz % 2))
    out["implicit_conv"] = mesh_line(torch, kernels, grad, conv_args,
                                     f"implicit conv (:41, nz {nz - nz % 2})",
                                     devices, n // 2, 2, card)
    out["drivers"] = driver_runs(kernels, n, opt.no_cuda, card)
    print(f"torch_mesh_cards: passed in {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
