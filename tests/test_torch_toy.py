"""The toy data and the toy final dump's panels, port against JAX.

Data: ``generate_toy_data`` byte for byte equal to the JAX package's for
every toy and split (small sizes, caches under tmp_path), the ``.npz`` cache
read back unchanged, ``toy_logpdf`` within 1e-5 of JAX's and normalised,
and ``get_dataset``'s info. Panels: the histogram counts and the
probability grid equal to the arrays the JAX twin draws (captured from its
imshow call), each picture PANEL x PANEL x 3 uint8 in [0, 255], and the
port's visualization never imports matplotlib.
"""

import subprocess
import sys

import numpy as np
import pytest

from ardae_tpu.data import get_dataset as j_get
from ardae_tpu.data.toy import generate_toy_data as j_generate
from ardae_tpu.data.toy import toy_logpdf as j_logpdf
from ardae_tpu_torch.data import get_dataset as t_get
from ardae_tpu_torch.data.toy import generate_toy_data as t_generate
from ardae_tpu_torch.data.toy import toy_logpdf as t_logpdf
from ardae_tpu_torch.utils import visualization as tvis

SIZES = dict(train=1003, val=101, test=257)


@pytest.mark.parametrize("name", ["25gaussians", "swissroll", "toy3", "gaussian"])
def test_generate_toy_data_is_byte_identical(tmp_path, name):
    want = j_generate(name, sizes=SIZES, cache_dir=str(tmp_path / "jax"))
    got = t_generate(name, sizes=SIZES, cache_dir=str(tmp_path / "port"))
    cached = t_generate(name, sizes=SIZES, cache_dir=str(tmp_path / "port"))
    for split in ("train", "val", "test"):
        for w, g, c in zip(want[split], got[split], cached[split]):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert g.tobytes() == w.tobytes() == c.tobytes(), split


@pytest.mark.parametrize("name", ["25gaussians", "toy3", "gaussian"])
def test_toy_logpdf(name):
    x = np.random.default_rng(0).normal(scale=3.0, size=(200, 2)).astype(np.float32)
    np.testing.assert_allclose(t_logpdf(name)(x), np.asarray(j_logpdf(name)(x)),
                               rtol=1e-5, atol=1e-5)
    # normalised: the density integrates to 1 over a wide grid
    lin = np.linspace(-12, 12, 601)
    xv, yv = np.meshgrid(lin, lin)
    dens = np.exp(t_logpdf(name)(np.stack([xv, yv], axis=-1)))
    assert abs(dens.sum() * (lin[1] - lin[0]) ** 2 - 1.0) < 1e-3


def test_get_dataset_toy(tmp_path):
    want = j_get("25gaussians", root=str(tmp_path / "jax"), toy_sizes=SIZES)
    got = t_get("25gaussians", root=str(tmp_path / "port"), toy_sizes=SIZES)
    for split in ("train", "val", "test"):
        assert got[split].tobytes() == want[split].tobytes()
        assert np.array_equal(got["info"]["labels"][split],
                              want["info"]["labels"][split])
    for k in ("binarize", "center", "synthetic", "nclasses"):
        assert got["info"][k] == want["info"][k], k
    assert t_get("swissroll", root=str(tmp_path), toy_sizes=SIZES)["info"]["logpdf"] is None


def _jax_imshow_arrays(monkeypatch, fn, *args, **kw):
    """Call a JAX panel function and return (its picture, the array it
    handed to imshow)."""
    import matplotlib.axes

    seen = []
    real = matplotlib.axes.Axes.imshow
    monkeypatch.setattr(matplotlib.axes.Axes, "imshow",
                        lambda self, a, *x, **k: seen.append(np.array(a))
                        or real(self, a, *x, **k))
    image = fn(*args, **kw)
    monkeypatch.setattr(matplotlib.axes.Axes, "imshow", real)
    return image, seen[0]


def _check_panel(image, want):
    assert image.dtype == np.uint8 and image.shape == want.shape == (500, 500, 3)
    assert image.min() >= 0 and image.max() <= 255
    chw = tvis.convert_npimage_torchimage(image)
    assert chw.shape == (3, 500, 500) and 0.0 <= chw.min() <= chw.max() <= 1.0


@pytest.mark.parametrize("val,num", [(6, 256), (4, 128)])
def test_histogram_counts_equal_jax(monkeypatch, val, num):
    from ardae_tpu.utils import visualization as jvis

    data = np.random.default_rng(1).normal(scale=2.5, size=(5000, 2)).astype(np.float32)
    want_img, want = _jax_imshow_arrays(monkeypatch, jvis.get_2d_histogram_plot,
                                        data, val=val, num=num)
    np.testing.assert_array_equal(tvis.histogram2d(data, val, num), want)
    _check_panel(tvis.get_imshow_plot(tvis.histogram2d(data, val, num)), want_img)


def test_probability_grid_equals_jax(monkeypatch):
    from ardae_tpu.core.energy import normal_energy_func as j_energy
    from ardae_tpu.utils import visualization as jvis
    from ardae_tpu_torch.core.energy import normal_energy_func as t_energy

    want = jvis.get_prob_from_energy_func_for_vis(j_energy, num=256)
    got = tvis.get_prob_from_energy_func_for_vis(t_energy, num=256)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    want_img, shown = _jax_imshow_arrays(monkeypatch, jvis.get_imshow_plot, want, val=4)
    np.testing.assert_array_equal(shown, want)
    _check_panel(tvis.get_imshow_plot(got), want_img)


def test_port_visualization_never_imports_matplotlib():
    code = ("import sys, numpy as np\n"
            "from ardae_tpu_torch.core.energy import normal_energy_func\n"
            "from ardae_tpu_torch.utils import visualization as v\n"
            "v.get_imshow_plot(v.histogram2d(np.zeros((4, 2), np.float32), 6, 256))\n"
            "v.get_imshow_plot(v.get_prob_from_energy_func_for_vis("
            "normal_energy_func))\n"
            "assert 'matplotlib' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=str(
        __import__("pathlib").Path(__file__).resolve().parents[1]))
