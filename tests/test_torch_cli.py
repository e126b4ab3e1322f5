"""The port's driver, ardae_tpu_torch.cli.ivae_ardae, on the CPU (--no-cuda):
2-step runs of the flagship line, the implicit-conv line and the
mnist-concat line at a tiny width on dbmnist-val5k, of the flagship on
sbMNIST, and of the four other resconv fc heads with --use-kernels; the
25-gaussians line (mlp-concat) on 2,000 toy points with its final dump; the
whole pipeline
(val IWS eval, best and periodic checkpoints, the test eval from the best
checkpoint, resume, final mode) on val and test splits cut to 64 items; and
the configs the port refuses, which must raise, among them --use-kernels
with a bf16 phase A. The bf16 runs themselves are
tests/test_torch_bf16_cli.py."""

import math
import os
import re

import pytest
import torch

from ardae_tpu_torch.cli import ivae_ardae
from torch_driver_data import shared_datasets, small_splits  # noqa: F401

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

# the mnist-concat line (:47) at a tiny width: h 16, z 8, noise 10
MNIST_CONCAT = list(IMPLICIT_CONV)
for _flag, _value in (("--model", "mnist-concat"), ("--model-h-dim", "16"),
                      ("--model-n-layers", "1"), ("--model-z-dim", "8"),
                      ("--model-n-dim", "10")):
    MNIST_CONCAT[MNIST_CONCAT.index(_flag) + 1] = _value

# the 25-gaussians line (scripts/run_vae_25gaussians.sh) at a tiny width and
# depth: h 16, bs 4, nz 8, 2,000 toy points
TOY = [
    "--dataset", "25gaussians", "--nheight", "1", "--nchannels", "2",
    "--toy-train-size", "2000", "--model", "mlp-concat", "--model-z-dim", "2",
    "--model-h-dim", "16", "--model-n-layers", "2", "--model-nonlin", "relu",
    "--model-n-dim", "10", "--cdae", "mlp-grad", "--cdae-h-dim", "16",
    "--cdae-n-layers", "3", "--cdae-nonlin", "softplus", "--cdae-ctx-type", "lt0",
    "--train-batch-size", "4", "--train-nz-cdae", "8", "--delta", "0.1",
    "--std-scale", "10000", "--m-optimizer", "adam", "--m-beta1", "0.5",
    "--d-optimizer", "rmsprop", "--d-momentum", "0.5", "--iws-samples", "64",
    "--max-iters", "2", "--log-interval", "1", "--eval-iws-interval", "0",
    "--vis-interval", "0", "--ckpt-interval", "0", "--no-resume"]

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


def test_mnist_concat_line_two_steps_on_cpu(tmp_path):
    from ardae_tpu_torch.models.ivae.mnist import MNISTIPVAE

    state, path = ivae_ardae.run(_args(tmp_path, "--use-kernels",
                                       base=MNIST_CONCAT))
    _check_two_steps(state, path)
    assert isinstance(state.model, MNISTIPVAE)
    assert len(state.model.encode.inp_encode.layers) == 2  # n_layers + 1


def test_toy_line_two_steps_and_final_dump(tmp_path):
    """mlp-concat + mlp-grad on 25gaussians with --use-kernels, then the toy
    final dump in place of the test eval: the 2,000 training points
    reconstructed and as many generated, the heatmaps written."""
    import numpy as np

    from ardae_tpu_torch.models.ivae.toy import ToyIPVAE

    state, path = ivae_ardae.run(_args(tmp_path, "--use-kernels", base=TOY))
    _check_two_steps(state, path)
    assert isinstance(state.model, ToyIPVAE)
    assert _log(path, "dataset 25gaussians: generated from seed 20200616")
    (dump,) = _log(path, "| toy dump")
    assert "| rows 2000 | non-finite 0" in dump and not _log(path, "| test")
    with np.load(os.path.join(path, "toy-dump.npz")) as z:
        assert z["data_recon_gen"].shape == (500, 1500, 3)
        assert z["gt_latent"].shape == (500, 1000, 3)
        # every data point lies inside [-6, 6]^2
        assert z["data_counts"].shape == (256, 256) and z["data_counts"].sum() == 2000


@pytest.mark.parametrize("model,head", [
    ("resconv", "mlp"), ("resconvct-res2", "res-mlp"),
    ("resconv-res3", "res-wn-mlp-lin"), ("resconvct-res4", "res-mlp-lin")])
def test_resconv_heads_two_steps_on_cpu(tmp_path, model, head):
    """The flagship line with --model changed: phase A takes the res-style
    op, whose CPU dispatch is its plain version."""
    args = _args(tmp_path, "--use-kernels")
    args[args.index("resconvct-res")] = model
    state, path = ivae_ardae.run(args)
    _check_two_steps(state, path)
    assert state.model.enc_type == head
    assert state.model.trunk.do_center == ("ct" in model)


@pytest.mark.parametrize("extra,what", [
    # bf16 trains now; the fused kernels refuse a bf16 phase A. The mesh
    # flags and --profile-dir run (tests/test_torch_cli_parallel.py)
    (["--cdae-compute-dtype", "bfloat16", "--use-kernels"], "bf16"),
])
def test_unsupported_flags_raise(tmp_path, extra, what):
    with pytest.raises(NotImplementedError, match=what):
        ivae_ardae.run(_args(tmp_path, *extra))


EVAL = ["--max-iters", "4", "--log-interval", "2", "--eval-iws-interval", "2",
        "--ckpt-interval", "2", "--eval-batch-size", "16"]


def _log(path, prefix):
    with open(os.path.join(path, "log.txt")) as f:
        return [ln for ln in f if ln.startswith(prefix)]


def _iws(lines):
    return [float(re.search(r"logprob \(iws\) (\S+)", ln).group(1)) for ln in lines]


@pytest.mark.parametrize("base,iws", [(BASE, "16"), (IMPLICIT_CONV, "64")],
                         ids=["flagship", "implicit-conv"])
def test_eval_and_checkpoints_on_cpu(tmp_path, small_splits, base, iws):
    """Val evals at iters 2 and 4, best-checkpoint and checkpoint, then the
    test eval from best-checkpoint."""
    args = [a for a in _args(tmp_path, *EVAL, "--iws-samples", iws, base=base)
            if a != "--skip-final-test-eval"]
    state, path = ivae_ardae.run(args)
    val, test = _log(path, "| val"), _log(path, "| test")
    assert [ln.split("|")[2].strip() for ln in val] == ["iter 2", "iter 4"]
    assert len(test) == 1
    v2, v4 = _iws(val)
    assert all(math.isfinite(v) and v < 0 for v in (v2, v4, *_iws(test)))
    # the test eval ran on best-checkpoint's state
    assert state.step == (4 if v4 > v2 else 2)
    assert {"checkpoint", "best-checkpoint"} <= set(os.listdir(path))


def test_resume_starts_at_the_saved_iteration(tmp_path):
    state, path = ivae_ardae.run(_args(tmp_path, "--max-iters", "4",
                                       "--log-interval", "2", "--ckpt-interval", "2"))
    state, path2 = ivae_ardae.run(_args(tmp_path, "--max-iters", "6",
                                        "--log-interval", "2", "--resume"))
    assert path2 == path and state.step == 6
    iters = [ln.split("|")[1].strip() for ln in _log(path, "| iter ")]
    assert iters == ["iter 2", "iter 4", "iter 6"]
    assert _log(path, "| resumed from checkpoint at iter 4")


def test_final_mode_trains_to_the_best_iteration(tmp_path, small_splits):
    """--train-mode final reads end_iter from best-checkpoint, trains that
    many steps on train+val (60,000 rows: 15,000 steps an epoch at bs 4),
    writes final-checkpoint and evaluates the test split from it."""
    from ardae_tpu_torch.io.checkpoint import load_end_iter

    _, path = ivae_ardae.run(_args(tmp_path, *EVAL, "--iws-samples", "16"))
    end_iter = load_end_iter(path, "best-checkpoint")
    args = [a for a in _args(tmp_path, "--train-mode", "final", "--resume",
                             "--iws-samples", "16", "--max-iters", "10")
            if a != "--skip-final-test-eval"]
    state, path2 = ivae_ardae.run(args)
    assert path2 == path and state.step == end_iter
    assert "final-checkpoint" in os.listdir(path)
    assert end_iter in (1, 3)  # best at iter 2 or 4, less one
    assert all("/15000 |" in ln for ln in _log(path, "| iter ")[-end_iter:])
    assert _log(path, "End of training (final)")
    assert len(_log(path, "| test")) == 1


def test_sbmnist_flagship_two_steps_on_cpu(tmp_path):
    args = _args(tmp_path)
    args[args.index("dbmnist-val5k")] = "sbmnist"
    state, path = ivae_ardae.run(args)
    _check_two_steps(state, path)
    assert _log(path, "dataset sbmnist: SYNTHETIC")


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
    """Every --model name trains now (the aux ones: test_torch_aux_cli.py;
    in bf16 too: test_torch_bf16_cli.py); the legacy --cdae mlp model is
    still refused, as in JAX."""
    args = _args(tmp_path)
    args[args.index("mlp-res")] = "mlp"
    with pytest.raises(NotImplementedError, match="legacy"):
        ivae_ardae.run(args)


def test_no_gpu_without_no_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    args = [a for a in _args(tmp_path) if a != "--no-cuda"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ivae_ardae.run(args)
