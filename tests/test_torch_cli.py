"""The port's driver, ardae_tpu_torch.cli.ivae_ardae, on the CPU (--no-cuda):
2-step runs of the flagship line and of the implicit-conv line at a tiny
width on dbmnist-val5k, and the flags and configs the port does not cover,
which must raise."""

import math
import os
import re

import pytest
import torch

from ardae_tpu_torch.cli import ivae_ardae

BASE = ["--dataset", "dbmnist-val5k", "--nheight", "28", "--nchannels", "1",
        "--train-batch-size", "4", "--m-optimizer", "adam", "--m-beta1", "0.9",
        "--d-optimizer", "rmsprop", "--d-momentum", "0.9", "--d-beta1", "0.9",
        "--train-nz-cdae", "8", "--model", "resconvct-res", "--model-z-dim", "8",
        "--model-h-dim", "16", "--model-n-layers", "1", "--model-nonlin", "elu",
        "--model-n-dim", "10", "--cdae", "mlp-res", "--cdae-h-dim", "16",
        "--cdae-n-layers", "2", "--cdae-nonlin", "softplus",
        "--cdae-ctx-type", "lt0", "--m-lr", "0.001", "--d-lr", "0.0001",
        "--delta", "0.1", "--std-scale", "100", "--num-cdae-updates", "2",
        "--max-iters", "2", "--log-interval", "1", "--eval-iws-interval", "0",
        "--ckpt-interval", "0", "--skip-final-test-eval", "--no-resume"]

# the implicit-conv line (scripts/run_vae_dbmnist.sh:41) at a tiny width:
# bs 4, nz 8, cdae h 16
IMPLICIT_CONV = [
    "--dataset", "dbmnist-val5k", "--nheight", "28", "--nchannels", "1",
    "--train-batch-size", "4", "--m-optimizer", "adam", "--m-momentum", "0.5",
    "--m-beta1", "0.5", "--d-optimizer", "rmsprop", "--d-momentum", "0.5",
    "--d-beta1", "0.5", "--train-nz-cdae", "8", "--model", "mnist-conv",
    "--model-z-dim", "32", "--model-h-dim", "0", "--model-n-layers", "0",
    "--model-nonlin", "softplus", "--model-n-dim", "100", "--cdae", "mlp-grad",
    "--cdae-h-dim", "16", "--cdae-n-layers", "5", "--cdae-nonlin", "softplus",
    "--cdae-ctx-type", "lt0", "--m-lr", "0.0001", "--d-lr", "0.0001",
    "--delta", "0.1", "--std-scale", "10000", "--num-cdae-updates", "1",
    "--max-iters", "2", "--log-interval", "1", "--eval-iws-interval", "0",
    "--ckpt-interval", "0", "--skip-final-test-eval", "--no-resume"]

LOSSES = re.compile(r"loss \(vae\) (\S+) \| loss \(recon\) (\S+) \| "
                    r"loss \(prior\) (\S+) \| loss \(cdae\) (\S+)")


def _args(tmp_path, *extra, base=BASE):
    return base + ["--cache", str(tmp_path / "exp"), "--data-root",
                   str(tmp_path / "data"), "--no-cuda", *extra]


def _check_two_steps(state, path):
    assert state.step == 2
    with open(os.path.join(path, "log.txt")) as f:
        lines = [ln for ln in f if ln.startswith("| iter ")]
    assert [ln.split("|")[1].strip() for ln in lines] == ["iter 1", "iter 2"]
    for ln in lines:
        assert all(math.isfinite(float(v)) for v in LOSSES.search(ln).groups())


def test_two_steps_on_cpu(tmp_path):
    _check_two_steps(*ivae_ardae.run(_args(tmp_path, "--use-kernels")))
    assert ivae_ardae.main(_args(tmp_path)) == 0


def test_implicit_conv_line_two_steps_on_cpu(tmp_path):
    """mnist-conv + mlp-grad with --use-kernels: phase A takes the
    grad-style op, whose CPU dispatch is its plain version."""
    from ardae_tpu_torch.models.ivae.conv import ConvIPVAE

    state, path = ivae_ardae.run(_args(tmp_path, "--use-kernels",
                                       base=IMPLICIT_CONV))
    _check_two_steps(state, path)
    assert isinstance(state.model, ConvIPVAE)
    assert state.cdae.score_type == "grad" and state.cdae.h_dim == 16


@pytest.mark.parametrize("extra,what", [
    (["--eval-iws-interval", "1"], "IWS eval"),
    (["--ckpt-interval", "2"], "checkpoints"),
    (["--vis-interval", "1"], "visualization"),
    (["--train-mode", "final"], "final"),
    (["--cdae-compute-dtype", "bfloat16"], "bf16"),
    (["--dp-devices", "2"], "dp-devices"),
    (["--profile-dir", "prof"], "profile"),
    (["--m-weight-avg", "swa"], "weight-avg"),
])
def test_unsupported_flags_raise(tmp_path, extra, what):
    with pytest.raises(NotImplementedError, match=what):
        ivae_ardae.run(_args(tmp_path, *extra))


def test_final_test_eval_raises(tmp_path):
    args = [a for a in _args(tmp_path) if a != "--skip-final-test-eval"]
    with pytest.raises(NotImplementedError, match="final test-set IWS eval"):
        ivae_ardae.run(args)


def test_use_kernels_on_uncovered_cdae_raises(tmp_path):
    """An activation no kernel covers: the refusal names the guard."""
    args = _args(tmp_path, "--use-kernels")
    args[args.index("--cdae-nonlin") + 1] = "elu"
    with pytest.raises(NotImplementedError, match="supports_fused_dsm refused"):
        ivae_ardae.run(args)
    args[args.index("mlp-res")] = "mlp-grad"
    with pytest.raises(NotImplementedError, match="supports_fused_dsm_grad refused"):
        ivae_ardae.run(args)


def test_unported_model_raises(tmp_path):
    args = _args(tmp_path)
    args[args.index("resconvct-res")] = "mnist-concat"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ivae_ardae.run(args)


def test_no_gpu_without_no_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    args = [a for a in _args(tmp_path) if a != "--no-cuda"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ivae_ardae.run(args)
