"""mnist32 and StackedMNIST in the port against the JAX package: the
mnist32 splits byte-identical to ardae_tpu.data.get_dataset's, from the
synthetic surrogate (train and final mode) and from real idx files; every
name of get_image_dataset; make_stacked_mnist bit for bit at one seed; the
32 x 32 resize bit for bit, and against torch's bilinear interpolation
(align_corners=False) as tests/test_weight_avg.py:148 holds JAX's; both
port drivers on --dataset mnist32 at smoke widths, 2 steps each, against
both JAX drivers (whose parsers do not list mnist32, which their
get_dataset builds: the test widens their --dataset choices); and
mnist-conv at 32 x 32, which fails in the port as in JAX."""

import os
import struct

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ardae_tpu.data import get_dataset as j_get
from ardae_tpu.data import mnist as jmnist
from ardae_tpu_torch.data import get_dataset as t_get
from ardae_tpu_torch.data import mnist as tmnist

_SPLITS = ("train", "val", "test")


def _same(a, b):
    for split in _SPLITS:
        if a[split] is None:
            assert b[split] is None, split
            continue
        assert a[split].dtype == b[split].dtype == np.float32
        assert a[split].shape == b[split].shape, split
        assert a[split].tobytes() == b[split].tobytes(), split
        la, lb = a["info"]["labels"][split], b["info"]["labels"][split]
        assert la.dtype == lb.dtype and la.tobytes() == lb.tobytes(), split
    for k in ("binarize", "center", "synthetic", "labels_fallback", "nclasses",
              "image_size"):
        assert a["info"][k] == b["info"][k], k


@pytest.mark.parametrize("final_mode", [False, True])
def test_mnist32_surrogate_identical(tmp_path, final_mode):
    """The gray 32 x 32 splits, val 10,000 and its split cache named as
    JAX's; not binarized, so the Bernoulli likelihood takes gray values."""
    a = j_get("mnist32", root=str(tmp_path / "jax"), final_mode=final_mode)
    b = t_get("mnist32", root=str(tmp_path / "port"), final_mode=final_mode)
    assert b["train"].shape == ((60_000 if final_mode else 50_000), 1024)
    assert b["info"]["image_size"] == 32 and not b["info"]["binarize"]
    assert b["info"]["synthetic"]
    assert not set(np.unique(b["test"][:100])) <= {0.0, 1.0}
    if not final_mode:
        assert os.path.exists(tmp_path / "port" / "MNIST" / "mnist32-val10000-split.npz")
    _same(a, b)


def _write_idx(path, arr, magic):
    with open(path, "wb") as f:
        f.write(struct.pack(">I", magic))
        f.write(struct.pack(f">{arr.ndim}I", *arr.shape))
        f.write(arr.astype(np.uint8).tobytes())


@pytest.fixture
def idx_root(tmp_path):
    """Real-format idx files: 10,020 train and 50 test images."""
    raw = tmp_path / "MNIST" / "raw"
    os.makedirs(raw)
    rng = np.random.default_rng(0)
    _write_idx(raw / "train-images-idx3-ubyte", rng.integers(0, 256, (10_020, 28, 28)), 2051)
    _write_idx(raw / "t10k-images-idx3-ubyte", rng.integers(0, 256, (50, 28, 28)), 2051)
    _write_idx(raw / "train-labels-idx1-ubyte", rng.integers(0, 10, (10_020,)), 2049)
    _write_idx(raw / "t10k-labels-idx1-ubyte", rng.integers(0, 10, (50,)), 2049)
    return tmp_path


@pytest.mark.parametrize("name", ["mnist32", "mnist", "cmnist", "dbmnist",
                                  "dbmnist-val5k", "sbmnist"])
def test_get_image_dataset_identical(idx_root, name):
    """Each name of get_image_dataset, from real files (idx; sbMNIST's amat
    files), in JAX's order: JAX first, its split cache removed before the
    port makes its own."""
    d = idx_root / "bmnist"
    os.makedirs(d)
    rng = np.random.default_rng(1)
    for split, n in (("train", 7), ("valid", 3), ("test", 4)):
        rows = rng.integers(0, 2, (n, 784))
        (d / f"binarized_mnist_{split}.amat").write_text(
            "\n".join(" ".join(map(str, r)) for r in rows) + "\n")
    a = jmnist.get_image_dataset(name, root=str(idx_root))
    for f in os.listdir(idx_root / "MNIST"):
        if f.endswith(".npz"):
            os.remove(idx_root / "MNIST" / f)
    b = tmnist.get_image_dataset(name, root=str(idx_root))
    assert not b["info"]["synthetic"]
    if name == "sbmnist":
        for split in _SPLITS:
            assert a[split].tobytes() == b[split].tobytes()
        return
    assert b["train"].shape[1] == (1024 if name == "mnist32" else 784)
    _same(a, b)
    with pytest.raises(NotImplementedError):
        tmnist.get_image_dataset("mnist64", root=str(idx_root))


def test_stacked_mnist_bit_for_bit():
    """tests/test_weight_avg.py:130, and JAX's arrays at the same seed."""
    x = np.eye(10, 784, dtype=np.float32)
    y = np.arange(10, dtype=np.int64)
    imgs, labels = tmnist.make_stacked_mnist(x, y, 10, seed=0)
    assert imgs.shape == (10, 3 * 784)
    assert ((labels >= 0) & (labels <= 999)).all()
    assert (labels % 10 == np.arange(10) % 10).all()
    gray, lab = tmnist._synthetic_mnist(500, seed=3)
    for seed in (0, 7):
        a = jmnist.make_stacked_mnist(gray, lab, 1_200, seed=seed)
        b = tmnist.make_stacked_mnist(gray, lab, 1_200, seed=seed)
        for u, v in zip(a, b):
            assert u.dtype == v.dtype and u.tobytes() == v.tobytes()


def test_resize_bilinear():
    """tests/test_weight_avg.py:140-160: the shape, the mass, torch's
    half-pixel bilinear (atol 1e-5); and JAX's bytes."""
    x = np.random.default_rng(3).random((5, 784)).astype(np.float32)
    ours = tmnist._resize_bilinear(x, 32)
    assert ours.shape == (5, 1024) and ours.dtype == np.float32
    assert abs(ours.mean() - x.mean()) < 0.05
    ref = F.interpolate(torch.from_numpy(x).reshape(5, 1, 28, 28), size=(32, 32),
                        mode="bilinear", align_corners=False)[:, 0].numpy()
    np.testing.assert_allclose(ours.reshape(5, 32, 32), ref, atol=1e-5)
    assert ours.tobytes() == jmnist._resize_bilinear(x, 32).tobytes()


# ------------------------------- the drivers -------------------------------

SMOKE = ["--nheight", "32", "--nchannels", "1", "--train-batch-size", "4",
         "--max-iters", "2", "--log-interval", "1", "--eval-iws-interval", "0",
         "--ckpt-interval", "0", "--vis-interval", "50000", "--skip-final-test-eval",
         "--no-resume", "--exp-num", "1"]
# the mnist-concat line (scripts/run_vae_dbmnist.sh:47) at a tiny width
IVAE = ["--dataset", "mnist32", "--model", "mnist-concat", "--model-z-dim", "8",
        "--model-h-dim", "16", "--model-n-layers", "1", "--model-nonlin", "softplus",
        "--model-n-dim", "10", "--cdae", "mlp-grad", "--cdae-h-dim", "16",
        "--cdae-n-layers", "5", "--cdae-nonlin", "softplus", "--cdae-ctx-type",
        "lt0", "--train-nz-cdae", "8", "--m-optimizer", "adam", "--m-beta1", "0.5",
        "--d-optimizer", "rmsprop", "--d-momentum", "0.5", "--std-scale", "10000",
        "--delta", "0.1", "--num-cdae-updates", "1"]
# the mlp baseline line (:28) at a tiny width
VAE = ["--dataset", "mnist32", "--model", "mnist", "--model-z-dim", "4",
       "--model-h-dim", "16", "--model-n-layers", "2", "--model-nonlin", "softplus",
       "--optimizer", "adam", "--beta1", "0.5", "--lr", "0.0001", "--iws-samples", "8"]


def _widened(build):
    """A JAX parser whose --dataset also takes mnist32."""
    def build_parser():
        p = build()
        for a in p._actions:
            if a.dest == "dataset":
                a.choices = list(a.choices) + ["mnist32"]
        return p
    return build_parser


def _log(path):
    with open(os.path.join(path, "log.txt")) as f:
        return f.readlines()


def _lines(log, prefix):
    return [ln.split("|")[0].strip() if prefix.endswith(":") else ln
            for ln in log if ln.startswith(prefix)]


@pytest.mark.parametrize("driver", ["ivae", "vae"])
def test_drivers_on_mnist32_match_the_jax_drivers(monkeypatch, tmp_path, driver):
    """2 steps on mnist32, the data 1,024 wide: the same model (and cdae)
    parameter counts as the JAX driver's, 2 iteration lines each with
    finite losses, the same experiment name. Both read one copy of the
    splits (byte-identical: tests above)."""
    import ardae_tpu.cli.common as jcommon
    import ardae_tpu.data as jdata
    import ardae_tpu_torch.data as tdata
    from ardae_tpu.cli import ivae_ardae as jivae
    from ardae_tpu.cli import vae as jvae
    from ardae_tpu_torch.cli import ivae_ardae, vae

    splits = t_get("mnist32", root=str(tmp_path / "data"))
    assert splits["train"].shape[1] == 1024
    monkeypatch.setattr(jdata, "get_dataset", lambda *a, **k: dict(splits))
    monkeypatch.setattr(tdata, "get_dataset", lambda *a, **k: dict(splits))
    monkeypatch.setattr(jcommon, "enable_compile_cache", lambda: None)
    jmod, tmod, flags = ((jivae, ivae_ardae, IVAE) if driver == "ivae"
                         else (jvae, vae, VAE))
    monkeypatch.setattr(jmod, "build_parser", _widened(jmod.build_parser))
    argv = flags + SMOKE + ["--data-root", str(tmp_path / "data")]
    assert jmod.main(argv + ["--cache", str(tmp_path / "jax")]) == 0
    state, path = tmod.run(argv + ["--cache", str(tmp_path / "port"), "--no-cuda"])
    jpath = [os.path.join(r, d) for r, ds, _ in os.walk(tmp_path / "jax") for d in ds
             if os.path.exists(os.path.join(r, d, "log.txt"))]
    assert len(jpath) == 1
    # the name, less its start time
    name = lambda p, root: os.path.relpath(p, root).rsplit("-", 2)[0]
    assert name(jpath[0], tmp_path / "jax") == name(path, tmp_path / "port")
    jlog, tlog = _log(jpath[0]), _log(path)
    for prefix in ("model params", "cdae params") if driver == "ivae" else ("model params",):
        want = [ln.split("|")[0].strip() for ln in jlog if ln.startswith(prefix)]
        got = [ln.split("|")[0].strip() for ln in tlog if ln.startswith(prefix)]
        assert got == want and len(got) == 1, prefix
    for log in (jlog, tlog):
        iters = [ln for ln in log if ln.startswith("| iter ")]
        assert len(iters) == 2
        assert "nan" not in "".join(iters).lower()
    assert state.step == 2


def test_mnist_conv_on_mnist32_fails_in_both():
    """The conv IVAE is built for 28 x 28: at 32 x 32 its loss fails in
    JAX (shapes (2, 784) and (2, 1024)) and in the port."""
    import jax.numpy as jnp

    from ardae_tpu.models.ivae import api as japi
    from ardae_tpu.models.registry import build_ivae_model as j_build
    from ardae_tpu_torch.models.ivae import api as tapi
    from ardae_tpu_torch.models.registry import build_ivae_model as t_build

    kw = dict(nchannels=1, nheight=32, z_dim=8, n_dim=10, nonlin="softplus")
    jm = j_build("mnist-conv", **kw)
    x = np.random.default_rng(0).random((2, 1024)).astype(np.float32)
    with pytest.raises(TypeError, match="784"):
        p = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.zeros((2, 10)))
        japi.ivae_loss(jm, p, jax.random.PRNGKey(1), jnp.asarray(x), 1)
    tm = t_build("mnist-conv", device="cpu", **kw)
    with pytest.raises(RuntimeError, match="784"):
        tapi.ivae_loss(tm, torch.from_numpy(x), 1, generator=torch.Generator())
