"""The port's driver, ardae_tpu_torch.cli.ivae_ardae, on the CPU (--no-cuda):
a 2-step run of the flagship line at a tiny width on dbmnist-val5k, and the
flags and configs the slice does not cover, which must raise."""

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

LOSSES = re.compile(r"loss \(vae\) (\S+) \| loss \(recon\) (\S+) \| "
                    r"loss \(prior\) (\S+) \| loss \(cdae\) (\S+)")


def _args(tmp_path, *extra):
    return BASE + ["--cache", str(tmp_path / "exp"), "--data-root",
                   str(tmp_path / "data"), "--no-cuda", *extra]


def test_two_steps_on_cpu(tmp_path):
    state, path = ivae_ardae.run(_args(tmp_path, "--use-kernels"))
    assert state.step == 2
    with open(os.path.join(path, "log.txt")) as f:
        lines = [ln for ln in f if ln.startswith("| iter ")]
    assert [ln.split("|")[1].strip() for ln in lines] == ["iter 1", "iter 2"]
    for ln in lines:
        assert all(math.isfinite(float(v)) for v in LOSSES.search(ln).groups())
    assert ivae_ardae.main(_args(tmp_path)) == 0


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
    args = _args(tmp_path, "--use-kernels")
    args[args.index("mlp-res")] = "mlp-grad"
    with pytest.raises(NotImplementedError, match="queue 2"):
        ivae_ardae.run(args)


def test_unported_model_raises(tmp_path):
    args = _args(tmp_path)
    args[args.index("resconvct-res")] = "mnist-conv"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ivae_ardae.run(args)


def test_no_gpu_without_no_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    args = [a for a in _args(tmp_path) if a != "--no-cuda"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ivae_ardae.run(args)
