"""Both port drivers on a mesh of CPU ranks (--no-cuda --dp-devices /
--sp-devices), their refusals, --profile-dir, and the port's entry points
(ardae_tpu_torch/graft_entry.py), on the CPU over gloo.

The trajectory bound is tests/test_cli.py:183-185's: each logged ``loss
(vae)`` within 0.05 * (1 + |b|) of the single-rank run's. A driver resume
restarts the host index stream (cli/common.py, as JAX's driver does), so a
resumed driver run reads other batches than an uninterrupted one: the
bitwise resume of a mesh run is held at the chunk level
(tests/test_torch_parallel.py); here a resumed dp run is held to a resumed
single-rank run by the trajectory bound.
"""

import glob
import json
import math
import os
import re

import pytest
import torch

from ardae_tpu_torch import graft_entry
from ardae_tpu_torch.cli import ivae_ardae, vae
from test_cli import CANONICAL_25G

torch.set_num_threads(2)

VAE_TOY = (
    "--dataset 25gaussians --nheight 1 --nchannels 2 --model toy "
    "--model-z-dim 2 --model-h-dim 16 --model-n-layers 2 "
    "--model-nonlin softplus --train-batch-size 64 --optimizer adam "
    "--beta1 0.5 --lr 0.001 --epochs 1 --eval-iws-interval 0 "
    "--iws-samples 8 --log-interval 10 --vis-interval 100000 "
    "--ckpt-interval 100000 --toy-train-size 2000 --max-iters 20"
).split()  # tests/test_cli.py:190-197


def _run(driver, tmp_path, tag, *extra, base=CANONICAL_25G):
    state, path = driver.run(base + ["--no-cuda", "--cache", str(tmp_path / tag),
                                     "--data-root", str(tmp_path / "data"),
                                     "--skip-final-test-eval", *extra])
    with open(os.path.join(path, "log.txt")) as f:
        log = f.read()
    return state, path, log


def _losses(log, pattern=r"loss \(vae\) ([-\d.]+)"):
    return [float(v) for v in re.findall(pattern, log)]


def _close_trajectories(got, want):
    assert len(got) == len(want) > 0, (got, want)
    for a, b in zip(got, want):
        assert abs(a - b) < 0.05 * (1 + abs(b)), (got, want)


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """The single-rank run of CANONICAL_25G, 20 iterations."""
    tmp = tmp_path_factory.mktemp("single")
    return _losses(_run(ivae_ardae, tmp, "one", "--max-iters", "20")[2])


@pytest.mark.parametrize("extra,line", [
    (["--dp-devices", "2"], "data-parallel mesh over 2 cpu devices | backend gloo"),
    (["--dp-devices", "2", "--sp-devices", "2"],
     "(data, sample) mesh over 4 cpu devices (dp=2, sp=2) | backend gloo"),
], ids=["dp2", "dp2xsp2"])
def test_ivae_driver_on_a_mesh(tmp_path, single, extra, line):
    """JAX's tests/test_cli.py:160-185 and :372-395 at 2 and 2 x 2 ranks:
    the mesh line, the iterations, and the trajectory of the single run."""
    state, _, log = _run(ivae_ardae, tmp_path, "mesh", "--max-iters", "20", *extra)
    assert line in log and state.step == 20
    _close_trajectories(_losses(log), single)


def test_vae_driver_on_two_ranks(tmp_path):
    """JAX's tests/test_cli.py:188-200 at 2 ranks, beside the single run."""
    _, _, log = _run(vae, tmp_path, "dp", "--dp-devices", "2", base=VAE_TOY)
    assert "data-parallel mesh over 2 cpu devices | backend gloo" in log
    assert "| iter 20 " in log
    _, _, log1 = _run(vae, tmp_path, "one", base=VAE_TOY)
    pattern = r"\| loss ([-\d.]+)"
    _close_trajectories(_losses(log, pattern), _losses(log1, pattern))


def test_dp_run_resumes_from_its_checkpoint(tmp_path, single):
    """A dp run to iteration 10 (a checkpoint there), resumed to 20: every
    rank loads it, the log goes on at 20, and the trajectory holds the
    single-rank run's bound (the host stream restarts on resume)."""
    _run(ivae_ardae, tmp_path, "dp", "--max-iters", "10", "--ckpt-interval", "10",
         "--dp-devices", "2")
    state, _, log = _run(ivae_ardae, tmp_path, "dp", "--max-iters", "20",
                         "--dp-devices", "2", "--resume")
    assert "| resumed from checkpoint at iter 10" in log and state.step == 20
    iters = [int(v) for v in re.findall(r"^\| iter (\d+) ", log, re.M)]
    assert iters == [10, 20]
    _close_trajectories(_losses(log), single)


@pytest.mark.parametrize("driver,extra,what", [
    (ivae_ardae, ["--dp-devices", "3"], "--train-batch-size 64 not divisible by "
                                        "--dp-devices 3"),
    (ivae_ardae, ["--sp-devices", "3"], "--train-nz-cdae 8 not divisible by "
                                        "--sp-devices 3"),
    (ivae_ardae, ["--dp-devices", "2", "--sp-devices", "2", "--card"],
     "mesh needs 4 devices but only 1 are available"),
    (vae, ["--dp-devices", "3"], "--train-batch-size 64 not divisible by "
                                 "--dp-devices 3"),
    (vae, ["--dp-devices", "2", "--card"], "--dp-devices 2 but only 1 devices "
                                           "are available"),
], ids=["ivae-batch", "ivae-nz", "ivae-cards", "vae-batch", "vae-cards"])
def test_mesh_refusals(tmp_path, monkeypatch, driver, extra, what):
    """JAX's checks and messages (cli/ivae_ardae.py:378-390, cli/vae.py:
    278-285), SystemExit as there; the card count is checked only without
    --no-cuda (here a machine with one card)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    base = CANONICAL_25G if driver is ivae_ardae else VAE_TOY
    args = base + ["--cache", str(tmp_path), "--data-root", str(tmp_path / "d")]
    args += [a for a in extra if a != "--card"] + (
        [] if "--card" in extra else ["--no-cuda"])
    with pytest.raises(SystemExit, match=re.escape(what)):
        driver.run(args)


def test_profile_dir_writes_a_trace_and_trains_the_same(tmp_path):
    """--profile-dir: the first chunk after iteration 0 runs under
    torch.profiler, its Chrome trace parses and holds the step's ops, and
    the run logs the same numbers as one without it."""
    prof = tmp_path / "prof"
    args = ["--max-iters", "10", "--log-interval", "5"]
    _, _, log = _run(ivae_ardae, tmp_path, "plain", *args)
    _, _, log_p = _run(ivae_ardae, tmp_path, "prof", *args, "--profile-dir", str(prof))
    assert f"profiler trace written to {prof}" in log_p
    strip = lambda s: [re.sub(r"ms/step\s+\S+", "", ln) for ln in s.splitlines()
                       if ln.startswith("| iter ")]
    assert strip(log_p) == strip(log) and len(strip(log)) == 2
    (trace,) = glob.glob(str(prof / "*.json"))
    assert os.path.basename(trace) == "iter6-10.trace.json"
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"aten::mm", "aten::addmm"} & names


def test_entry_is_finite():
    """JAX's tests/test_graft_entry.py:9-14: the forward step of the conv
    IVAE (on the CPU, as asked)."""
    fn, args = graft_entry.entry(device="cpu")
    loss, (recon, prior) = fn(*args)
    assert all(math.isfinite(float(v.detach())) for v in (loss, recon, prior))


def test_dryrun_multichip_4_on_cpu_ranks(capsys):
    """JAX's tests/test_graft_entry.py:17-21 at 4 ranks: one joint step over
    a data-parallel mesh of 4, then over (2, 2), finite metrics."""
    metrics = graft_entry.dryrun_multichip(4, devices=["cpu"] * 4)
    out = capsys.readouterr().out
    assert "dryrun_multichip(4): ok" in out
    assert "dryrun_multichip(4): (data, sample)=(dp=2, sp=2) sharded joint step ok" in out
    assert len(metrics) == 2 and metrics[0].keys() == metrics[1].keys()
