"""The port's visualization (ardae_tpu_torch/utils/visualization.py and the
drivers' ``visualize``) against the JAX package: ``get_grid_image`` bit for
bit; the 2-D histogram's counts exactly; every panel's shape, dtype and
range; both port drivers on the CPU at a tiny width (toy data and the
synthetic MNIST surrogate, 4 steps, panels every 2) against the JAX drivers
at the same flags, each with a recording writer patched in by the test: the
same set of (kind, tag, image shape), and the JAX driver's panel tags are
the lists chip_smoke.py holds the port to on the card; and a run with
panels trains bit for bit as the same run without them."""

import numpy as np
import pytest
import torch

import ardae_tpu.utils.visualization as jvis
import chip_smoke
from ardae_tpu_torch.utils import visualization as tvis
from torch_driver_data import shared_datasets  # noqa: F401


class RecordingWriter:
    """What a driver hands its writer: (kind, tag, value) in order."""

    def __init__(self):
        self.items = []

    def add_scalar(self, tag, value, step=None):
        self.items.append(("scalar", tag, np.asarray(value)))

    def add_histogram(self, tag, values, step=None):
        self.items.append(("histogram", tag, np.asarray(values)))

    def add_image(self, tag, image, step=None):
        self.items.append(("image", tag, np.asarray(image)))

    def flush(self):
        pass

    def close(self):
        pass

    def signature(self):
        """{(kind, tag, an image's CHW shape)}."""
        return {(k, tag, v.shape if k == "image" else None)
                for k, tag, v in self.items}


def test_grid_image_is_the_jax_one_bit_for_bit():
    rng = np.random.default_rng(0)
    for n, c, h in ((13, 1, 28), (64, 3, 5), (70, 1, 4), (3, 2, 6)):
        imgs = rng.uniform(-0.2, 1.2, size=(n, c * h * h)).astype(np.float32)
        got = tvis.get_grid_image(imgs, n, c, h)
        want = jvis.get_grid_image(imgs, n, c, h)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_2d_histogram_counts_are_the_jax_ones(monkeypatch):
    """The counts the JAX panel hands imshow (captured by a stand-in
    figure) against the port's histogram2d, exactly, points outside the
    range and on its edges included."""
    rng = np.random.default_rng(1)
    data = np.concatenate([rng.normal(scale=3.0, size=(5000, 2)),
                           [[4.0, 4.0], [-4.0, -4.0], [4.0, -4.0]]])
    shown = []

    class Axes:
        def imshow(self, grid, **kw):
            shown.append(np.asarray(grid))

        def grid(self, *a):
            pass

    monkeypatch.setattr(jvis.plt, "subplots", lambda **kw: (None, Axes()))
    monkeypatch.setattr(jvis, "_fig_to_np", lambda fig: np.zeros((1, 1, 3)))
    for val, num in ((4, 128), (6, 256)):
        jvis.get_2d_histogram_plot(data, val=val, num=num)
        assert np.array_equal(tvis.histogram2d(data, val=val, num=num), shown[-1])


def test_panels_shape_dtype_range():
    """Each panel is PANEL x PANEL x 3 uint8, the JAX twin's figure size;
    the scatter draws on white and marks its points, y up."""
    rng = np.random.default_rng(2)
    data = rng.normal(size=(4096, 2))
    panels = [tvis.get_scatter_plot(data), tvis.get_2d_histogram_plot(data),
              tvis.get_1d_histogram_plot(data[:, 0]),
              tvis.get_imshow_plot(tvis.histogram2d(data))]
    jshape = jvis.get_scatter_plot(data[:64]).shape
    for p in panels:
        assert p.shape == jshape == (tvis.PANEL, tvis.PANEL, 3)
        assert p.dtype == np.uint8 and p.max() == 255
    img = tvis.convert_npimage_torchimage(panels[0])
    assert img.dtype == np.float32 and 0.0 <= img.min() and img.max() == 1.0
    one = tvis.get_scatter_plot(np.array([[3.0, 3.0], [np.nan, 0.0], [9.0, 0.0]]))
    marked = np.argwhere((one != 255).any(axis=-1))
    # one mark, in the top right quarter (row 0 is the top)
    assert len(marked) == 4
    assert marked[:, 0].max() < tvis.PANEL // 2 < marked[:, 1].min()


IVAE_TOY = (
    "--dataset 25gaussians --nheight 1 --nchannels 2 --toy-train-size 2000 "
    "--model mlp-concat --model-z-dim 2 --model-h-dim 16 --model-n-layers 2 "
    "--model-nonlin relu --model-n-dim 4 --cdae mlp-grad --cdae-h-dim 16 "
    "--cdae-n-layers 2 --cdae-nonlin softplus --cdae-ctx-type lt0 "
    "--train-batch-size 64 --eval-batch-size 1 --train-nz-cdae 8 --delta 0.1 "
    "--std-scale 100 --m-optimizer adam --d-optimizer rmsprop --iws-samples 8 "
    "--eval-iws-interval 4 --m-weight-avg polyak --m-weight-avg-start 2").split()
IVAE_MNIST = (
    "--dataset dbmnist-val5k --nheight 28 --nchannels 1 --model mnist-concat "
    "--model-z-dim 4 --model-h-dim 16 --model-n-layers 2 --model-nonlin softplus "
    "--model-n-dim 8 --cdae mlp-res --cdae-h-dim 16 --cdae-n-layers 2 "
    "--cdae-nonlin softplus --cdae-ctx-type lt0 --train-batch-size 8 "
    "--eval-batch-size 1 --train-nz-cdae 8 --delta 0.1 --std-scale 100 "
    "--m-optimizer adam --d-optimizer rmsprop --iws-samples 8 "
    "--eval-iws-interval 0 --skip-final-test-eval --m-weight-avg swa "
    "--m-weight-avg-start 3").split()
VAE_TOY = (
    "--dataset 25gaussians --nheight 1 --nchannels 2 --toy-train-size 2000 "
    "--model toy --model-z-dim 2 --model-h-dim 16 --model-n-layers 2 "
    "--model-nonlin softplus --train-batch-size 64 --optimizer adam --beta1 0.5 "
    "--lr 0.001 --iws-samples 8 --eval-iws-interval 4 --weight-avg polyak "
    "--weight-avg-start 2").split()
VAE_MNIST = (
    "--dataset dbmnist-val5k --nheight 28 --nchannels 1 --model mnist "
    "--model-z-dim 4 --model-h-dim 16 --model-n-layers 2 --model-nonlin softplus "
    "--train-batch-size 8 --optimizer adam --beta1 0.5 --lr 0.001 "
    "--iws-samples 8 --eval-iws-interval 0 --skip-final-test-eval").split()
STEPS = ["--max-iters", "4", "--log-interval", "2", "--ckpt-interval", "0",
         "--no-resume"]
CASES = {"ivae-toy": ("ivae", IVAE_TOY), "ivae-mnist": ("ivae", IVAE_MNIST),
         "vae-toy": ("vae", VAE_TOY), "vae-mnist": ("vae", VAE_MNIST)}


def _port_run(monkeypatch, tmp_path, driver, flags, vis):
    import ardae_tpu_torch.cli.common as common
    from ardae_tpu_torch.cli import ivae_ardae, vae

    rec = RecordingWriter()
    monkeypatch.setattr(common, "make_writer", lambda path: rec)
    mod = ivae_ardae if driver == "ivae" else vae
    state, path = mod.run(flags + STEPS + [
        "--vis-interval", str(vis), "--no-cuda", "--cache", str(tmp_path / "port"),
        "--data-root", str(tmp_path / "data")])
    return rec, state, path


@pytest.mark.parametrize("case", list(CASES))
def test_driver_panels_match_the_jax_driver(monkeypatch, tmp_path, case):
    """Every tag either driver writes in a 4-step run with panels every 2
    steps (and, on the toy data, the final panels and dump), with each
    image's shape: the same for the port as for the JAX driver."""
    import ardae_tpu.cli.common as jcommon
    import ardae_tpu.io.logging as jlogging
    from ardae_tpu.cli import ivae_ardae as jivae
    from ardae_tpu.cli import vae as jvae

    driver, flags = CASES[case]
    jrec = RecordingWriter()
    monkeypatch.setattr(jlogging, "make_writer", lambda path: jrec)
    # the JAX driver's persistent compile cache would write under HOME
    monkeypatch.setattr(jcommon, "enable_compile_cache", lambda: None)
    main = jivae.main if driver == "ivae" else jvae.main
    assert main(flags + STEPS + ["--vis-interval", "2", "--cache",
                                 str(tmp_path / "jax"), "--data-root",
                                 str(tmp_path / "data")]) == 0
    rec, state, _ = _port_run(monkeypatch, tmp_path, driver, flags, 2)
    assert rec.signature() == jrec.signature()
    # the lists chip_smoke.py holds the port's panels to on the card
    kind = (driver, case.split("-")[1])
    panels = {(k, tag) for k, tag, _ in jrec.items if k != "scalar" or "/enc/" in tag}
    dump = chip_smoke.DUMP_TAGS if kind[1] == "toy" else set()
    assert panels == chip_smoke.VIS_TAGS[kind] | dump
    images = [v for k, _, v in rec.items if k == "image"]
    assert images and all(v.dtype == np.float32 and np.isfinite(v).all()
                          and v.min() >= 0.0 and v.max() <= 1.0 for v in images)
    assert all(np.isfinite(v).all() for k, _, v in rec.items if k != "image")
    averaging = "--m-weight-avg" in flags or "--weight-avg" in flags
    assert (state.avg_model is not None) == averaging


def _tensors(state):
    sd = state.state_dict()
    out = {}
    for part, v in sd.items():
        if isinstance(v, dict) and "state" in v:     # an optimizer
            out.update({f"{part}.{i}.{n}": x for i, st in v["state"].items()
                        for n, x in st.items()})
        elif isinstance(v, dict):
            out.update({f"{part}.{k}": x for k, x in v.items()})
        else:
            out[part] = v
    return out


@pytest.mark.parametrize("case", ["ivae-mnist", "vae-toy"])
def test_panels_leave_training_bit_for_bit(monkeypatch, tmp_path, case):
    """The same 4 steps with panels every 2 steps and with none end in the
    same state bit for bit: every panel draw comes from the generator of
    (seed, VIS_TAG, iteration), none from the training one. Both runs log
    every 2 steps, so both train in the same chunks."""
    driver, flags = CASES[case]
    with_vis, s1, path = _port_run(monkeypatch, tmp_path / "a", driver, flags, 2)
    without, s2, _ = _port_run(monkeypatch, tmp_path / "b", driver, flags, 0)
    with open(f"{path}/log.txt") as f:
        assert sum(ln.startswith("| vis ") for ln in f) >= 2
    t1, t2 = _tensors(s1), _tensors(s2)
    assert t1.keys() == t2.keys()
    for k, v in t1.items():
        same = torch.equal(v, t2[k]) if isinstance(v, torch.Tensor) else v == t2[k]
        assert same, k
    # a toy run draws its panels once more before the dump, with or without
    assert len(with_vis.items) > len(without.items)
