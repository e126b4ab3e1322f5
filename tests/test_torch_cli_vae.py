"""The port's baseline driver, ardae_tpu_torch.cli.vae, on the CPU
(--no-cuda): 2-step runs of the three baseline lines of
scripts/run_vae_dbmnist.sh (resconv :16, conv :22, mlp :28) at a tiny width
(bs 4, z 4, mlp h 16) on dbmnist-val5k and of the resconv line on sbMNIST;
the toy baseline on 2,000 25-gaussians points, with a val IWAE eval and the
toy final dump;
experiment names equal to the JAX driver's; the whole pipeline (val IWAE
eval, best and periodic checkpoints, the test eval from the best
checkpoint, resume, final mode) on val and test splits cut to 64 items; and
the flags the port does not cover, which must raise. The bf16 runs are
tests/test_torch_bf16_cli.py."""

import math
import os
import re

import pytest
import torch

from ardae_tpu.cli import vae as jvae
from ardae_tpu_torch.cli import vae
from torch_driver_data import shared_datasets, small_splits  # noqa: F401

COMMON = ["--dataset", "dbmnist-val5k", "--nheight", "28", "--nchannels", "1",
          "--train-batch-size", "4", "--model-z-dim", "4", "--model-n-dim", "0",
          "--model-clip-logvar", "none", "--exp-num", "1", "--lr", "0.0001",
          "--beta-fin", "1.0", "--beta-annealing", "0", "--iws-samples", "8",
          "--weight-avg", "none", "--weight-avg-start", "-1",
          "--weight-avg-decay", "0.998", "--vis-interval", "0",
          "--train-mode", "train", "--max-iters", "2", "--log-interval", "1",
          "--eval-iws-interval", "0", "--ckpt-interval", "0",
          "--skip-final-test-eval", "--no-resume"]
LINES = {
    "resconv": ["--optimizer", "adam", "--momentum", "0.9", "--beta1", "0.9",
                "--model", "resconv", "--model-h-dim", "0", "--model-n-layers",
                "0", "--model-nonlin", "elu", "--beta-init", "0.0001"],
    "conv": ["--optimizer", "adam", "--momentum", "0.5", "--beta1", "0.5",
             "--model", "conv", "--model-h-dim", "0", "--model-n-layers", "0",
             "--model-nonlin", "softplus", "--beta-init", "1.0"],
    "mlp": ["--optimizer", "adam", "--momentum", "0.5", "--beta1", "0.5",
            "--model", "mnist", "--model-h-dim", "16", "--model-n-layers", "2",
            "--model-nonlin", "softplus", "--beta-init", "1.0"],
}
LOSSES = re.compile(r"\| loss (\S+) \| loss \(recon\) (\S+) \| loss \(kld\) (\S+) "
                    r"\| elbo (\S+)")


def _args(tmp_path, *extra, line="resconv"):
    return COMMON + LINES[line] + ["--cache", str(tmp_path / "exp"),
                                   "--data-root", str(tmp_path / "data"),
                                   "--no-cuda", *extra]


def _log(path, prefix):
    with open(os.path.join(path, "log.txt")) as f:
        return [ln for ln in f if ln.startswith(prefix)]


@pytest.mark.parametrize("line", list(LINES))
def test_two_steps_on_cpu(tmp_path, line):
    from ardae_tpu_torch.models.vae.conv import MNISTConvVAE
    from ardae_tpu_torch.models.vae.mnist import MNISTVAE
    from ardae_tpu_torch.models.vae.resconv import MNISTResConvVAE

    state, path = vae.run(_args(tmp_path, line=line))
    assert state.step == 2 and state.cdae is None
    want = {"resconv": MNISTResConvVAE, "conv": MNISTConvVAE, "mlp": MNISTVAE}[line]
    assert isinstance(state.model, want)
    lines = _log(path, "| iter ")
    assert [ln.split("|")[1].strip() for ln in lines] == ["iter 1", "iter 2"]
    for ln in lines:
        loss, recon, kld, elbo = map(float, LOSSES.search(ln).groups())
        assert all(math.isfinite(v) for v in (loss, recon, kld, elbo))
        # the logged loss is the one scaled by 1/(C*H*W) at beta 1
        assert abs(loss - (recon + kld) / 784) <= 1e-3 * abs(loss)
        assert abs(elbo + recon + kld) <= 1e-3 * abs(elbo)


def test_sbmnist_two_steps_on_cpu(tmp_path):
    args = _args(tmp_path)
    args[args.index("dbmnist-val5k")] = "sbmnist"
    state, path = vae.run(args)
    assert state.step == 2 and _log(path, "dataset sbmnist: SYNTHETIC")


@pytest.mark.parametrize("line", list(LINES))
def test_experiment_name_matches_the_jax_driver(line):
    argv = COMMON + LINES[line]
    assert (vae.derive_experiment(vae.build_parser().parse_args(argv))
            == jvae.derive_experiment(jvae.build_parser().parse_args(argv)))


# the toy baseline on the 25-gaussians data at a tiny width (z 2, h 16, bs
# 4), evaluated at iter 2 on the 500-point val split
TOY = ["--dataset", "25gaussians", "--nheight", "1", "--nchannels", "2",
       "--toy-train-size", "2000", "--model", "toy", "--model-z-dim", "2",
       "--model-h-dim", "16", "--model-n-layers", "2", "--model-nonlin", "softplus",
       "--train-batch-size", "4", "--optimizer", "adam", "--beta1", "0.5",
       "--lr", "0.001", "--iws-samples", "8", "--max-iters", "2",
       "--log-interval", "1", "--eval-iws-interval", "2", "--vis-interval", "0",
       "--ckpt-interval", "0", "--no-resume", "--no-cuda"]


def test_toy_two_steps_and_final_dump(tmp_path):
    from ardae_tpu_torch.models.vae.toy import ToyVAE

    state, path = vae.run(TOY + ["--cache", str(tmp_path / "exp"),
                                 "--data-root", str(tmp_path / "data")])
    assert state.step == 2 and isinstance(state.model, ToyVAE)
    for ln in _log(path, "| iter "):
        loss, recon, kld, elbo = map(float, LOSSES.search(ln).groups())
        # the loss scaled by 1 / (C * H * W) = 1 / 2 at beta 1
        assert abs(loss - (recon + kld) / 2) <= 1e-5 * abs(loss)
    (val,) = _log(path, "| val")
    assert all(math.isfinite(float(v)) for v in BOUNDS.search(val).groups())
    (dump,) = _log(path, "| toy dump")
    assert "| rows 2000 | non-finite 0" in dump and not _log(path, "| test")
    assert os.path.exists(os.path.join(path, "toy-dump.npz"))


EVAL = ["--max-iters", "4", "--log-interval", "2", "--eval-iws-interval", "2",
        "--ckpt-interval", "2", "--eval-batch-size", "16"]
BOUNDS = re.compile(r"elbo (\S+) \| logprob \(iws\) (\S+)")


def _with_test_eval(args):
    return [a for a in args if a != "--skip-final-test-eval"]


def test_pipeline_eval_checkpoints_resume_and_final_mode(tmp_path, small_splits):
    """Val evals at iters 2 and 4, best-checkpoint and checkpoint, the test
    eval from best-checkpoint; a resume to iter 6 that logs only iter 6;
    then --train-mode final, which trains to the best iteration less one
    on train+val (60,000 rows: 15,000 steps an epoch at bs 4), writes
    final-checkpoint and evaluates the test split from it."""
    from ardae_tpu_torch.io.checkpoint import load_end_iter

    state, path = vae.run(_with_test_eval(_args(tmp_path, *EVAL)))
    val, test = _log(path, "| val"), _log(path, "| test")
    assert [ln.split("|")[2].strip() for ln in val] == ["iter 2", "iter 4"]
    assert len(test) == 1
    bounds = [tuple(map(float, BOUNDS.search(ln).groups())) for ln in val + test]
    for elbo, lp in bounds:
        assert math.isfinite(elbo) and math.isfinite(lp) and lp < 0 and elbo < 0
    (_, v2), (_, v4) = bounds[:2]
    assert state.step == (4 if v4 > v2 else 2)  # the test eval's state
    assert {"checkpoint", "best-checkpoint"} <= set(os.listdir(path))

    state, path2 = vae.run(_args(tmp_path, "--max-iters", "6", "--log-interval",
                                 "2", "--resume"))
    assert path2 == path and state.step == 6
    iters = [ln.split("|")[1].strip() for ln in _log(path, "| iter ")]
    assert iters == ["iter 2", "iter 4", "iter 6"]
    assert _log(path, "| resumed from checkpoint at iter 4")

    end_iter = load_end_iter(path, "best-checkpoint")
    assert end_iter in (1, 3)  # best at iter 2 or 4, less one
    state, path3 = vae.run(_with_test_eval(_args(
        tmp_path, "--train-mode", "final", "--resume", "--max-iters", "10")))
    assert path3 == path and state.step == end_iter
    assert "final-checkpoint" in os.listdir(path)
    assert all("/15000 |" in ln for ln in _log(path, "| iter ")[-end_iter:])
    assert _log(path, "End of training (final)")
    assert len(_log(path, "| test")) == 2


@pytest.mark.parametrize("extra,what", [
    # the two bf16 cases left with the refusal they tested (bf16 trains:
    # test_torch_bf16_cli.py); this one keeps its id
    pytest.param(["--dp-devices", "2"], "dp-devices.*slice 7",
                 id="extra1-dp-devices.*slice 7"),
])
def test_unsupported_flags_raise(tmp_path, extra, what):
    with pytest.raises(NotImplementedError, match=what):
        vae.run(_args(tmp_path, *extra))


def test_no_gpu_without_no_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    args = [a for a in _args(tmp_path) if a != "--no-cuda"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vae.run(args)
