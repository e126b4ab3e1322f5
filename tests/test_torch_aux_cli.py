"""The six hierarchical-aux lines of scripts/run_vae_dbmnist.sh through the
port's drivers on the CPU (--no-cuda), at a tiny width on the synthetic
dbmnist-val5k: the implicit auxresconvct (:38, mlp-res, hidden1a 450 wide),
auxconv (:44, mlp-grad, 1,600) and auxmnist (:50, mlp-grad, 2h) lines with
--use-kernels (on the CPU each fused op runs its plain version, so no
launch is counted) and the -clip twin of :38; the baselines auxresconv
(:19), auxconv (:25) and auxmnist (:31) through cli.vae. Each trains 2
steps; the auxmnist lines of both drivers then run the pipeline on val and
test splits cut to 64 items (val evals, best and periodic checkpoints, the
test eval from best-checkpoint, a resume that logs only its own
iterations). An aux state (model, cdae, both optimizers, the generator)
round-trips through a checkpoint bit for bit.

Widths: bs 4, z 8, z0 10, MLP h 16, nz_cdae 8, cdae h 16; the baselines
z 4, IWAE-8."""

import math
import os
import re

import pytest
import torch

from ardae_tpu_torch.cli import ivae_ardae, vae
from ardae_tpu_torch.ops.fused_dsm import FusedDSMFunction
from ardae_tpu_torch.ops.fused_dsm_grad import FusedDSMGradFunction
from test_torch_cli import IMPLICIT_CONV, LOSSES
from test_torch_cli_vae import COMMON
from test_torch_cli_vae import LOSSES as VAE_LOSSES
from torch_driver_data import shared_datasets, small_splits  # noqa: F401


def _line(base, **flags):
    out = list(base)
    for k, v in flags.items():
        out[out.index("--" + k.replace("_", "-")) + 1] = v
    return out


# scripts/run_vae_dbmnist.sh :38 / :44 / :50 at a tiny width; :38 keeps its
# optimizers (adam 0.9, rmsprop 0.9), lrs, beta annealing and std-scale 100
_AUX = _line(IMPLICIT_CONV, model_z_dim="8", model_n_dim="10",
             cdae_ctx_type="hidden1a")
IMPLICIT = {
    "auxresconvct": _line(
        _AUX, model="auxresconvct", model_nonlin="elu", cdae="mlp-res",
        m_momentum="0.9", m_beta1="0.9", d_momentum="0.9", d_beta1="0.9",
        m_lr="0.001", std_scale="100", num_cdae_updates="2") + [
        "--beta-init", "0.0001", "--beta-fin", "1.0", "--beta-annealing", "50000"],
    "auxconv": _line(_AUX, model="auxconv"),
    "auxmnist": _line(_AUX, model="auxmnist", model_h_dim="16",
                      model_n_layers="2"),
}
IMPLICIT["auxresconvct-clip"] = _line(IMPLICIT["auxresconvct"],
                                      model="auxresconvct-clip")
CONTEXT = {"auxresconvct": 450, "auxresconvct-clip": 450, "auxconv": 1600,
           "auxmnist": 32}
# :19 / :25 / :31 at the baseline tests' tiny width
BASELINE = {
    "auxresconv": ["--optimizer", "adam", "--momentum", "0.9", "--beta1", "0.9",
                   "--model", "auxresconv", "--model-h-dim", "0",
                   "--model-n-layers", "0", "--model-nonlin", "elu",
                   "--beta-init", "0.0001"],
    "auxconv": ["--optimizer", "adam", "--momentum", "0.5", "--beta1", "0.5",
                "--model", "auxconv", "--model-h-dim", "0", "--model-n-layers",
                "0", "--model-nonlin", "softplus", "--beta-init", "1.0"],
    "auxmnist": ["--optimizer", "adam", "--momentum", "0.5", "--beta1", "0.5",
                 "--model", "auxmnist", "--model-h-dim", "16",
                 "--model-n-layers", "2", "--model-nonlin", "softplus",
                 "--beta-init", "1.0"],
}


def _ivae_args(tmp_path, name, *extra):
    return IMPLICIT[name] + ["--cache", str(tmp_path / "exp"), "--data-root",
                             str(tmp_path / "data"), "--no-cuda", "--use-kernels",
                             *extra]


def _vae_args(tmp_path, name, *extra):
    # the line's z0 width (--model-n-dim) after COMMON's 0
    return COMMON + BASELINE[name] + [
        "--model-n-dim", "10", "--cache", str(tmp_path / "exp"),
        "--data-root", str(tmp_path / "data"), "--no-cuda", *extra]


def _log(path, prefix):
    with open(os.path.join(path, "log.txt")) as f:
        return [ln for ln in f if ln.startswith(prefix)]


def _launches():
    return {**FusedDSMFunction.launches, **FusedDSMGradFunction.launches}


@pytest.mark.parametrize("name", list(IMPLICIT))
def test_implicit_aux_line_two_steps_on_cpu(tmp_path, name):
    from ardae_tpu_torch.models.ivae import aux

    before = _launches()
    state, path = ivae_ardae.run(_ivae_args(tmp_path, name))
    assert _launches() == before  # CPU tensors: the plain versions
    assert state.step == 2 and state.model.family == "aux"
    want = {"auxconv": aux.MNISTConvAuxIPVAE,
            "auxmnist": aux.MNISTAuxIPVAE}.get(name, aux.MNISTResConvAuxIPVAE)
    assert isinstance(state.model, want)
    assert state.model.z0_min_std == (1.0 if name.endswith("clip") else 0.0)
    assert state.cdae.context_dim == CONTEXT[name]
    assert _log(path, "cdae params")[0].rstrip().endswith(
        f"context hidden1a, {CONTEXT[name]} wide")
    lines = _log(path, "| iter ")
    assert [ln.split("|")[1].strip() for ln in lines] == ["iter 1", "iter 2"]
    for ln in lines:
        assert all(math.isfinite(float(v)) for v in LOSSES.search(ln).groups())


@pytest.mark.parametrize("name", list(BASELINE))
def test_baseline_aux_line_two_steps_on_cpu(tmp_path, name):
    state, path = vae.run(_vae_args(tmp_path, name))
    assert state.step == 2 and state.cdae is None
    assert state.model.family == "aux_gaussian_posterior"
    assert state.model.noise_dim == 10
    lines = _log(path, "| iter ")
    assert [ln.split("|")[1].strip() for ln in lines] == ["iter 1", "iter 2"]
    for ln in lines:
        loss, recon, kld, elbo = map(float, VAE_LOSSES.search(ln).groups())
        assert all(math.isfinite(v) for v in (loss, recon, kld, elbo))
        # beta 1: the scaled loss is (recon + both KLDs) / 784
        assert abs(loss - (recon + kld) / 784) <= 1e-3 * abs(loss)


EVAL = ["--max-iters", "4", "--log-interval", "2", "--eval-iws-interval", "2",
        "--ckpt-interval", "2", "--eval-batch-size", "16"]


def _bounds(lines, label):
    return [float(re.search(label + r" (\S+)", ln).group(1)) for ln in lines]


@pytest.mark.parametrize("driver", ["ivae_ardae", "vae"])
def test_auxmnist_pipeline_eval_and_resume(tmp_path, small_splits, driver):
    """Val evals at iters 2 and 4 (IWS-16 with jitter 1e-5, or IWAE-8 and
    the ELBO), best-checkpoint, checkpoint and the test eval from
    best-checkpoint; then a resume to iter 6 that logs only iter 6."""
    if driver == "vae":
        run, args = vae.run, lambda *e: _vae_args(tmp_path, "auxmnist", *e)
    else:
        run = ivae_ardae.run
        args = lambda *e: _ivae_args(tmp_path, "auxmnist", "--iws-samples", "16", *e)
    first = [a for a in args(*EVAL) if a != "--skip-final-test-eval"]
    state, path = run(first)
    val, test = _log(path, "| val"), _log(path, "| test")
    assert [ln.split("|")[2].strip() for ln in val] == ["iter 2", "iter 4"]
    assert len(test) == 1
    v2, v4 = _bounds(val, r"logprob \(iws\)")
    assert all(math.isfinite(v) and v < 0
               for v in (v2, v4, *_bounds(test, r"logprob \(iws\)")))
    if driver == "vae":
        assert all(math.isfinite(v) for v in _bounds(val + test, "elbo"))
    assert state.step == (4 if v4 > v2 else 2)  # the test eval's state
    assert {"checkpoint", "best-checkpoint"} <= set(os.listdir(path))

    state, path2 = run(args("--max-iters", "6", "--log-interval", "2",
                            "--eval-iws-interval", "0", "--resume"))
    assert path2 == path and state.step == 6
    iters = [ln.split("|")[1].strip() for ln in _log(path, "| iter ")]
    assert iters == ["iter 2", "iter 4", "iter 6"]
    assert _log(path, "| resumed from checkpoint at iter 4")


def test_aux_state_checkpoint_roundtrip(tmp_path):
    """The auxresconvct line's state after 2 steps, saved and loaded into a
    fresh state of the same line: every tensor of the model, the cdae and
    both optimizers, and the generator's state, bit for bit."""
    from ardae_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint

    state, path = ivae_ardae.run(_ivae_args(tmp_path, "auxresconvct"))
    gen = torch.Generator().manual_seed(3)
    torch.randn(5, generator=gen)
    save_checkpoint(state, {"i_ep": 2, "best_val_loss": -1.0}, path, "rt", gen)
    fresh, _ = ivae_ardae.run(_ivae_args(tmp_path, "auxresconvct", "--max-iters",
                                         "1", "--seed", "4"))
    gen2 = torch.Generator()
    _, meta = load_checkpoint(fresh, path, "rt", gen2)
    assert meta["i_ep"] == 2 and fresh.step == 2
    assert torch.equal(gen2.get_state(), gen.get_state())
    want, got = state.state_dict(), fresh.state_dict()
    for part in ("model", "cdae"):
        assert want[part].keys() == got[part].keys()
        for k, v in want[part].items():
            assert torch.equal(got[part][k], v), (part, k)
    for part in ("opt_model", "opt_cdae"):
        ws, gs = want[part]["state"], got[part]["state"]
        assert ws.keys() == gs.keys()
        for i in ws:
            for k, v in ws[i].items():
                assert torch.equal(torch.as_tensor(gs[i][k]), torch.as_tensor(v))
