"""The harness on the CPU at smoke widths: the result line, the error
line, the refusal without a card, the comparison against the plain
reference, and ``correct`` coming out false when the timed path is broken
underneath (a step that leaves the state unchanged, all of it, the
convolutions' alone or the cdae's; half of the batch left out, the mean
taken over the rest)."""

import functools
import io
import json
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

from portbench.tests import tinycopy

KEYS = ["correct", "attempted", "failed", "metrics", "device"]
SEED = 3_000_000_019


@pytest.fixture(scope="module")
def copies(tmp_path_factory):
    out = {}
    for config in ("flagship", "implicit-conv"):
        d = tmp_path_factory.mktemp(config)
        out[config] = (str(d), tinycopy.make(str(d), config))
    return out


def _main(root, argv):
    """``run.main`` with the card's check skipped, on the copy at ``root``;
    returns (exit code, stdout lines, stderr lines)."""
    from portbench import run

    saved = run.bench
    run.bench = functools.partial(saved, require_cuda=False, root=root, out=lambda s: print(s))
    out, err = io.StringIO(), io.StringIO()
    try:
        with redirect_stdout(out), redirect_stderr(err):
            rc = run.main(argv)
    finally:
        run.bench = saved
    return rc, out.getvalue().splitlines(), err.getvalue().splitlines()


def _argv(cell, trace=0, seed=SEED):
    return ["--workload", cell, "--seed", str(seed), "--seconds", "0.05", "--trace", str(trace)]


@pytest.mark.parametrize("config", ["flagship", "implicit-conv"])
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(copies, config, trace):
    root, cells = copies[config]
    rc, out, err = _main(root, _argv(cells[1], trace))
    assert rc == 0, err
    result = json.loads(out[-1])
    extra = ["breakdown"] if trace else []
    assert list(result) == KEYS + extra + ["checks"]
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 2 and result["failed"] == 0
    if trace:
        assert "train_mfu_pct" in result["metrics"]
        assert {"busy_s", "window_s"} <= set(result["device"])
    else:
        assert set(result["metrics"]) == {"step_ms", "setup_s"}
    # every number compared is printed beside its limit, last on stderr
    assert [line.split()[1] for line in err[-4:]] == list(result["checks"])
    assert all(" limit " in line for line in err[-4:])
    assert any(line.startswith("setup setup_s ") for line in out[:-1])


@pytest.mark.parametrize("config", ["flagship", "implicit-conv"])
@pytest.mark.parametrize("kind", [0, 1])
def test_reference_follows_port(copies, config, kind):
    """The plain reference against the port (its plain path, and its
    kernel path, which runs the kernels' plain versions on the CPU)."""
    root, cells = copies[config]
    rc, out, err = _main(root, _argv(cells[kind]))
    checks = json.loads(out[-1])["checks"]
    assert checks["cdae_loss_gap"]["value"] <= 1e-6
    assert checks["model_loss_gap"]["value"] <= 1e-6
    assert checks["grad_norm_gap"]["value"] <= 1e-5
    assert checks["delta_norm_gap"]["value"] <= 1e-4


def test_error_line(copies):
    root, _ = copies["flagship"]
    rc, out, err = _main(root, _argv("no-such-cell"))
    assert rc == 1
    assert not any(line.startswith("{") for line in out)
    assert err[-1].startswith("error: KeyError") and "Traceback" not in "\n".join(err)


def test_no_card_no_result(copies):
    """Without a card the command exits 2 and prints no result."""
    root, cells = copies["flagship"]
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "-m", "portbench.run"] + _argv(cells[0]), cwd=root,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 2
    assert p.stdout.strip() == ""
    assert p.stderr.strip().splitlines()[-1].startswith("error: no CUDA device")


def _unchanged(monkeypatch):
    from ardae_tpu_torch.train import optim

    monkeypatch.setattr(optim.TorchAdam, "step", lambda self: None)
    monkeypatch.setattr(optim.TorchRMSprop, "step", lambda self: None)


def _half_batch(monkeypatch):
    """Phase A's loss over the first half of the items only."""
    from ardae_tpu_torch.train import step

    loss = step.cdae_loss

    def half(module, latent, context, std, eps=None, **kw):
        b = latent.shape[0] // 2
        rows = eps.shape[0] // latent.shape[0] * b
        return loss(module, latent[:b], context[:b], std[:b], eps=eps[:rows], **kw)

    monkeypatch.setattr(step, "cdae_loss", half)


def _conv_weights_unchanged(monkeypatch):
    """Adam's update dropped for the 4-D leaves (the convolutions) alone:
    a minority of leaves, whose optimizer state moves as it should."""
    from ardae_tpu_torch.train import optim

    step = optim.TorchAdam.step

    def partial(self, *a, **k):
        convs = [p for g in self.param_groups for p in g["params"] if p.dim() == 4]
        kept = [p.detach().clone() for p in convs]
        out = step(self, *a, **k)
        with torch.no_grad():
            for p, v in zip(convs, kept):
                p.copy_(v)
        return out

    monkeypatch.setattr(optim.TorchAdam, "step", partial)


def _cdae_unchanged(monkeypatch):
    """The cdae's optimizer leaves its weights as they were."""
    from ardae_tpu_torch.train import optim

    monkeypatch.setattr(optim.TorchRMSprop, "step", lambda self: None)


@pytest.mark.parametrize("config", ["flagship", "implicit-conv"])
@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _conv_weights_unchanged,
                                   _cdae_unchanged])
def test_fault_is_not_correct(copies, monkeypatch, config, fault):
    root, cells = copies[config]
    fault(monkeypatch)
    rc, out, err = _main(root, _argv(cells[1]))
    assert rc == 0, err
    assert json.loads(out[-1])["correct"] is False


@pytest.mark.cuda
def test_cuda_control_fails(copies):
    """On a card: the reference computed with TF32 products in the
    program's place reads past the limits (the control of the
    comparison), at smoke widths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench import calibrate

    for config in ("flagship", "implicit-conv"):
        root, cells = copies[config]
        readings = calibrate.readings(cells[1], [SEED, SEED + 1, SEED + 2], root=root)
        assert any(not r["control_correct"] for r in readings)

