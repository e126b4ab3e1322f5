"""Both port drivers in bf16 on the CPU (--no-cuda), 2 steps each at the
driver tests' tiny widths: cli.ivae_ardae with --cdae-compute-dtype
bfloat16 --model-compute-dtype bfloat16 (the canonical sweep's BF16,
scripts/run_canonical_sweep.sh) on the flagship, implicit-conv,
mnist-concat, 25-gaussians (with its final dump), auxmnist (hidden1a) and
auxresconvct-clip lines, and with --model-compute-dtype bfloat16
--use-kernels (phase A fp32 through the fused ops' plain versions on the
CPU); the flagship in bf16 through val evals, which stay fp32; cli.vae with
--model-compute-dtype bfloat16 (BF16_VAE) on the resconv, conv, mlp,
auxmnist, toy and toy-maf baselines. Each run logs finite losses and
keeps fp32 master parameters and optimizer state; a bf16 run trains other
numbers than the fp32 one from the same seed."""

import math
import os
import re

import pytest
import torch

from ardae_tpu_torch.cli import ivae_ardae, vae
from ardae_tpu_torch.ops.fused_dsm import FusedDSMFunction
from ardae_tpu_torch.ops.fused_dsm_grad import FusedDSMGradFunction
from test_torch_aux_cli import BASELINE as AUX_BASELINE
from test_torch_aux_cli import IMPLICIT as AUX_IMPLICIT
from test_torch_cli import BASE, IMPLICIT_CONV, LOSSES, MNIST_CONCAT, TOY
from test_torch_cli_vae import COMMON, LINES
from test_torch_cli_vae import LOSSES as VAE_LOSSES
from test_torch_cli_vae import TOY as VAE_TOY
from torch_driver_data import shared_datasets, small_splits  # noqa: F401

BF16 = ["--cdae-compute-dtype", "bfloat16", "--model-compute-dtype", "bfloat16"]
BF16_VAE = ["--model-compute-dtype", "bfloat16"]
IVAE_LINES = {
    "flagship": BASE, "implicit-conv": IMPLICIT_CONV,
    "mnist-concat": MNIST_CONCAT, "25-gaussians": TOY,
    "auxmnist": AUX_IMPLICIT["auxmnist"],
    "auxresconvct-clip": AUX_IMPLICIT["auxresconvct-clip"],
}


def _log(path, prefix):
    with open(os.path.join(path, "log.txt")) as f:
        return [ln for ln in f if ln.startswith(prefix)]


def _fp32_state(state):
    """Master parameters, the averaged model and every optimizer slot
    fp32."""
    modules = [m for m in (state.model, state.cdae) if m is not None]
    for m in modules:
        assert all(p.dtype == torch.float32 for p in m.parameters())
    for opt in (state.opt_model, state.opt_cdae):
        if opt is None:
            continue
        for slot in opt.state_dict()["state"].values():
            assert all(v.dtype in (torch.float32, torch.int64, torch.int32)
                       for v in slot.values() if isinstance(v, torch.Tensor))


def _ivae(tmp_path, line, *extra):
    args = IVAE_LINES[line] + ["--cache", str(tmp_path / "exp"), "--data-root",
                               str(tmp_path / "data"), "--no-cuda", *extra]
    state, path = ivae_ardae.run(args)
    assert state.step == 2
    lines = _log(path, "| iter ")
    assert [ln.split("|")[1].strip() for ln in lines] == ["iter 1", "iter 2"]
    losses = [float(v) for ln in lines for v in LOSSES.search(ln).groups()]
    assert all(math.isfinite(v) for v in losses)
    _fp32_state(state)
    return state, path, losses


@pytest.mark.parametrize("line", list(IVAE_LINES))
def test_ivae_driver_bf16_two_steps_on_cpu(tmp_path, line):
    """Both phases in bf16 (no --use-kernels: the kernels are fp32 only);
    the 25-gaussians line ends in its toy final dump."""
    _, path, losses = _ivae(tmp_path / "bf16", line, *BF16)
    _, _, fp32 = _ivae(tmp_path / "fp32", line)
    assert losses != fp32
    if line == "25-gaussians":
        (dump,) = _log(path, "| toy dump")
        assert "| rows 2000 | non-finite 0" in dump


@pytest.mark.parametrize("line,fn", [("flagship", FusedDSMFunction),
                                     ("implicit-conv", FusedDSMGradFunction)])
def test_ivae_driver_bf16_phase_b_with_kernels_on_cpu(tmp_path, line, fn):
    """--model-compute-dtype bfloat16 --use-kernels: phase A takes the
    fused op of the cdae's style (on CPU tensors its plain version: no
    launch), phase B bf16."""
    launches = dict(fn.launches)
    _ivae(tmp_path, line, "--model-compute-dtype", "bfloat16", "--use-kernels")
    assert fn.launches == launches


def test_ivae_driver_bf16_phase_a_with_kernels_raises(tmp_path):
    with pytest.raises(NotImplementedError,
                       match=r"ardae_tpu/train/step\.py:186-192"):
        ivae_ardae.run(IVAE_LINES["implicit-conv"] + [
            "--cache", str(tmp_path / "exp"), "--data-root", str(tmp_path / "data"),
            "--no-cuda", "--use-kernels", *BF16])


def test_ivae_driver_bf16_evals_stay_fp32(tmp_path, small_splits):
    """A bf16 flagship run with val evals at iters 1 and 2 (IWS-16 over 64
    items, the fp32 model) and best-checkpoint."""
    _, path, _ = _ivae(tmp_path, "flagship", *BF16, "--eval-iws-interval", "1",
                       "--iws-samples", "16", "--eval-batch-size", "16")
    val = _log(path, "| val")
    assert len(val) == 2
    for ln in val:
        v = float(re.search(r"logprob \(iws\) (\S+)", ln).group(1))
        assert math.isfinite(v) and v < 0
    assert "best-checkpoint" in os.listdir(path)


VAE_LINES = {
    **{k: COMMON + v for k, v in LINES.items()},
    "auxmnist": COMMON + AUX_BASELINE["auxmnist"] + ["--model-n-dim", "10"],
    "toy": VAE_TOY[:-1],
    "toy-maf": [a if a != "toy" else "toy-maf" for a in VAE_TOY[:-1]],
}


def _vae(tmp_path, line, *extra):
    args = VAE_LINES[line] + ["--cache", str(tmp_path / "exp"), "--data-root",
                              str(tmp_path / "data"), "--no-cuda", *extra]
    state, path = vae.run(args)
    assert state.step == 2 and state.cdae is None
    losses = [float(v) for ln in _log(path, "| iter ")
              for v in VAE_LOSSES.search(ln).groups()]
    assert len(losses) == 8 and all(math.isfinite(v) for v in losses)
    _fp32_state(state)
    return losses


@pytest.mark.parametrize("line", list(VAE_LINES))
def test_vae_driver_bf16_two_steps_on_cpu(tmp_path, line):
    """The baseline step in bf16 (toy-maf's flow on the fp32 parameters);
    the toy lines evaluate at iter 2 and dump, in fp32."""
    losses = _vae(tmp_path / "bf16", line, *BF16_VAE)
    assert losses != _vae(tmp_path / "fp32", line)
